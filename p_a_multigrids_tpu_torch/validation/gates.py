"""Acceptance gates: L1/L2/Linf error norms with the reference tolerance
(numpy copy of the JAX package's ``validation/gates.py``).

The reference passes/fails at L1 < 0.01
(Check_thermal_analytical_validation.py:25,210-217; My_version.py:21,
208-225 adds L2 and Linf with the same bound).
"""

from __future__ import annotations

import dataclasses

import numpy as np

TOLERANCE_L1_NORM = 0.01


@dataclasses.dataclass
class GateResult:
    l1: float
    l2: float
    linf: float
    passed: bool

    def __str__(self):
        verdict = "works OK" if self.passed else "does NOT work"
        return (f"L1={self.l1:.3e} L2={self.l2:.3e} Linf={self.linf:.3e} "
                f"-> {verdict}")


def check(computed: np.ndarray, expected: np.ndarray,
          tol: float = TOLERANCE_L1_NORM) -> GateResult:
    computed = np.asarray(computed, np.float64).ravel()
    expected = np.asarray(expected, np.float64).ravel()
    mask = np.isfinite(computed) & np.isfinite(expected)
    d = computed[mask] - expected[mask]
    l1 = float(np.abs(d).mean())
    l2 = float(np.sqrt((d ** 2).mean()))
    linf = float(np.abs(d).max())
    return GateResult(l1=l1, l2=l2, linf=linf, passed=l1 < tol)

"""Closed-form solutions used as validation gates (numpy/scipy copy of the
JAX package's ``validation/analytical.py``).

Reproduces the reference's off-line validation formulas:
- the erfc transient advection-diffusion breakthrough solution
  (the reference's Check_thermal_analytical_validation.py:34-43),
- the sin(x+y) manufactured solution (splitting.F90:1401-1405),
- the moving-box pure-advection comparison (transport_rect.F90:100-111).
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfc  # scipy ships with the baked-in stack


def breakthrough_erfc(x, t: float, gamma: float = 1.0) -> np.ndarray:
    """1-D advection-diffusion breakthrough curve with inlet T=1 at x=0.

    Identical term-for-term to the reference's analytical_solution
    (Check_thermal_analytical_validation.py:34-43): an Ogata-Banks profile
    plus an image-term correction at the x=2 outflow.
    """
    x = np.asarray(x, np.float64)
    st = 2.0 * np.sqrt(t)
    term1 = erfc((x - gamma * t) / st)
    term2 = np.exp(gamma * x) * erfc((x + gamma * t) / st)
    term3 = 1.0 + 0.5 * gamma * (2.0 - x + gamma * t)
    term4 = erfc((2.0 - x + gamma * t) / st)
    term5 = (gamma * np.sqrt(t / np.pi)
             * np.exp(-((2.0 - x + gamma * t) ** 2) / (4.0 * t)))
    return (0.5 * (term1 + term2)
            + np.exp(gamma) * (term3 * term4 - term5))


def manufactured_sin(x, y) -> np.ndarray:
    """sin(x+y): simultaneously BC, analytical field and (via -k*laplace)
    source of the reference's mode-9 validation."""
    return np.sin(np.asarray(x) + np.asarray(y))


def moving_box(x, t: float, u: float, x0: float, x1: float,
               length: float = 100.0) -> np.ndarray:
    """Pure-advection analytical comparison: the initial box [x0, x1]
    translated by u*t (transport_rect.F90:100-111)."""
    x = np.asarray(x, np.float64)
    lo = x0 + u * t
    hi = x1 + u * t
    return ((x >= lo) & (x <= hi)).astype(np.float64)

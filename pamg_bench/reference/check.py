"""The comparisons that decide ``correct``, and their control.

Two kinds, named by a traffic mix's ``check``:

- ``solve``: a step that solves its implicit system by a Krylov method to
  ``krylov_tol`` is judged by what it says it did.  The number is the
  relative residual of the returned state in the reference's own system,
  ||b_lin - A_lin x||_2 / ||b_lin||_2 in float64, b_lin from the step's
  input state (the theta right-hand side) and A_lin, b_lin assembled from
  the mesh (``dg``).  It covers the operator, the right-hand side and the
  solve at once.
- ``cycle``: a step of bare multigrid cycles returns an approximation, so
  the reference runs the same cycles (``multigrid.GeometricCycle``) in
  float64 from the same input, and the number is
  ||x - x_ref||_2 / ||x_ref||_2.

Each returns the worst number over the sampled steps.  The controls put
the reference in the program's place in TF32 (10 mantissa bits, the next
precision below the configurations' float32 with TF32 off): ``solve``'s
solves the TF32-rounded system by float64 PCG to 1e-12 and rounds its
answer; ``cycle``'s runs the cycles with every matrix and vector rounded.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch

from . import dg, multigrid


class SolveCheck:
    """``solve``: the implicit system of the finest level."""

    name = "rel_residual"

    def __init__(self, X: np.ndarray, cfg: dict):
        if cfg.get("theta", 1.0) != 1.0:
            raise ValueError("SolveCheck: implicit (theta = 1) steps only")
        self.dt = cfg["dt"]
        self.level = dg.assemble(X, cfg["n_split"], 0, self.dt, 1.0)

    def number(self, T_prev: np.ndarray, x: np.ndarray) -> float:
        b = dg.rhs(self.level, T_prev, self.dt)
        r = b - self.level.A @ x
        return float(np.linalg.norm(r) / np.linalg.norm(b))

    def control(self, T_prev: np.ndarray) -> np.ndarray:
        rnd = multigrid.tf32
        b = rnd(dg.rhs(self.level, T_prev, self.dt))
        return rnd(pcg_f64(rnd(self.level.A), b, rnd(T_prev)))


class CycleCheck:
    """``cycle``: the configuration's bare geometric cycles."""

    name = "rel_state_error"

    def __init__(self, X: np.ndarray, cfg: dict):
        if cfg.get("theta", 1.0) != 1.0:
            raise ValueError("CycleCheck: implicit (theta = 1) steps only")
        self.X, self.cfg = X, cfg
        self.cycle = multigrid.GeometricCycle(X, cfg)

    def number(self, T_prev: np.ndarray, x: np.ndarray) -> float:
        x_ref = self.cycle.step(T_prev)
        return float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))

    def control(self, T_prev: np.ndarray) -> np.ndarray:
        if not hasattr(self, "_low"):
            self._low = multigrid.GeometricCycle(self.X, self.cfg,
                                                 rnd=multigrid.tf32)
        return self._low.step(multigrid.tf32(T_prev))


CHECKS = {"solve": SolveCheck, "cycle": CycleCheck}


def worst(check, pairs) -> float:
    """The largest number of ``check`` over (T_prev, x) pairs of flat
    float64 states; a non-finite state reads inf."""
    out = 0.0
    for T_prev, x in pairs:
        if not np.all(np.isfinite(x)):
            return float("inf")
        out = max(out, check.number(T_prev, x))
    return out


def pcg_f64(A: sp.csr_matrix, b: np.ndarray, x0: np.ndarray,
            tol: float = 1e-12, maxiter: int = 50000) -> np.ndarray:
    """x with ||b - A x|| <= tol ||b||, by PCG with A's 3x3 diagonal blocks
    in float64 (torch, on the card where there is one)."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"

    def csr(M):
        M = M.tocsr()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # CSR support is "beta"
            return torch.sparse_csr_tensor(
                torch.as_tensor(M.indptr, dtype=torch.int64),
                torch.as_tensor(M.indices, dtype=torch.int64),
                torch.as_tensor(M.data), size=M.shape,
                dtype=torch.float64, check_invariants=True).to(dev)

    At, Dt = csr(A), csr(dg.diag_block_inverse(A.tocsr()))
    mv = lambda M, v: (M @ v[:, None])[:, 0]
    bt = torch.as_tensor(b, device=dev)
    x = torch.as_tensor(x0, device=dev).clone()
    r = bt - mv(At, x)
    z = mv(Dt, r)
    p = z.clone()
    rz = r @ z
    atol = tol * torch.linalg.vector_norm(bt)
    for _ in range(maxiter):
        if torch.linalg.vector_norm(r) <= atol:
            break
        Ap = mv(At, p)
        alpha = rz / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        z = mv(Dt, r)
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    else:
        raise RuntimeError("pcg_f64: no convergence")
    return x.cpu().numpy()

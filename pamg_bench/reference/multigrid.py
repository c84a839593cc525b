"""The plain geometric multigrid cycle of a time step, in NumPy float64 on
the matrices of ``dg``: the algorithm a configuration names, worked out
again from the mesh, so that the state a bare-cycle step returns can be
compared entry by entry.

The cycle on level l with right-hand side b from x:
- smooth: one Chebyshev polynomial (``cheb_degree`` roots in
  [cheb_lower lam, lam], lam the power estimate of the largest eigenvalue
  of D^-1 A, D the 3x3 diagonal blocks), repeated max(1, n_smooth //
  degree) times, each root a round x <- x + (1 / root) D^-1 (b - A x);
- r = b - A x, restricted by P^T (P: ``dg.prolongation``), the coarse
  cycle from 0 (twice on the top two levels for W-cycles), x += P e;
- smooth again.
The coarsest level solves exactly when it has at most
``coarse_direct_max_dof`` unknowns, else runs one polynomial of
``coarse_cheb_degree`` roots (or ``coarse_sweeps`` of the fine one).

``rnd`` rounds every stored matrix and every vector after each operation:
the identity for the reference, ``tf32`` for the control.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from . import dg


def chebyshev_roots(lam: float, degree: int, lower: float) -> list:
    """Roots of the Chebyshev polynomial of [lower lam, lam], taken large
    and small in turn."""
    a, b = lower * lam, lam
    ks = np.arange(1, degree + 1)
    roots = 0.5 * (b + a) + 0.5 * (b - a) * np.cos(
        np.pi * (2 * ks - 1) / (2 * degree))
    order, lo, hi = [], 0, degree - 1
    while lo <= hi:
        order.append(float(roots[lo]))
        lo += 1
        if lo <= hi:
            order.append(float(roots[hi]))
            hi -= 1
    return order


def lam_max(A: sp.csr_matrix, Dinv: sp.csr_matrix, U: int, C: int,
            iters: int = 12) -> float:
    """1.2 times the power estimate of the largest eigenvalue of D^-1 A,
    ``iters`` normalised products from the seed-0 normal vector of shape
    (U, C, 3)."""
    v = np.random.default_rng(0).normal(size=(U, C, 3)).reshape(-1)
    for _ in range(iters):
        w = Dinv @ (A @ v)
        v = w / np.linalg.norm(w)
    return 1.2 * float(np.linalg.norm(Dinv @ (A @ v)))


def tf32(a):
    """Round float values to TF32 (10 explicit mantissa bits, to nearest
    even), kept in float64; a sparse matrix has its values rounded."""
    if sp.issparse(a):
        out = a.copy()
        out.data = tf32(out.data)
        return out
    f = np.asarray(a, np.float32)
    bits = f.view(np.uint32).astype(np.uint64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


class GeometricCycle:
    """The cycle of ``cfg`` (SemiConfig fields as a dict) on the levels
    of macros X, split cfg["n_split"] times, cfg["multi_levels"] levels."""

    def __init__(self, X: np.ndarray, cfg: dict, rnd=lambda a: a):
        if cfg.get("amg") or cfg.get("krylov"):
            raise ValueError("GeometricCycle: bare geometric cycles only")
        self.cfg, self.rnd = cfg, rnd
        n, nl = cfg["n_split"], cfg.get("multi_levels", 1)
        dt = cfg["dt"]
        self.levels = [dg.assemble(X, n - i, i, dt, 1.0) for i in range(nl)]
        if (nl > 1 and cfg.get("coarse_agg", True)
                and 3 * self.levels[-1].U * self.levels[-1].C
                > cfg.get("coarse_direct_max_dof", 4096)):
            raise ValueError("GeometricCycle: SA levels below the coarsest "
                             "are not followed")
        self.A = [rnd(l.A) for l in self.levels]
        Dinv = [dg.diag_block_inverse(l.A) for l in self.levels]
        self.Dinv = [rnd(D) for D in Dinv]
        self.P = [rnd(dg.prolongation(self.levels[i], self.levels[i + 1]))
                  for i in range(nl - 1)]
        self.lam = [lam_max(l.A, D, l.U, l.C)
                    for l, D in zip(self.levels, Dinv)]
        self.direct = None
        Nc = self.A[-1].shape[0]
        if nl > 1 and Nc <= cfg.get("coarse_direct_max_dof", 4096):
            self.direct = spla.factorized(self.A[-1].tocsc())

    def _coefs(self, li: int, sweeps: int) -> list:
        cfg = self.cfg
        deg = cfg.get("cheb_degree", 6)
        lower = cfg.get("cheb_lower", 0.1)
        coarse_override = (cfg.get("coarse_cheb_degree") is not None
                           and len(self.levels) > 1
                           and li == len(self.levels) - 1)
        if coarse_override:
            deg = cfg["coarse_cheb_degree"]
            lower = cfg.get("coarse_cheb_lower") or lower
        roots = chebyshev_roots(self.lam[li], deg, lower)
        reps = 1 if coarse_override else max(1, sweeps // len(roots))
        return [1.0 / r for r in roots] * reps

    def _smooth(self, li: int, x, b, sweeps: int):
        A, Dinv, rnd = self.A[li], self.Dinv[li], self.rnd
        for coef in self._coefs(li, sweeps):
            x = rnd(x + coef * rnd(Dinv @ rnd(b - A @ x)))
        return x

    def cycle(self, li: int, x, b):
        cfg, rnd = self.cfg, self.rnd
        nl = len(self.levels)
        n_smooth = cfg.get("n_smooth", 4)
        if li == nl - 1:
            if nl > 1 and self.direct is not None:
                return rnd(self.direct(b))
            sweeps = cfg.get("coarse_sweeps", 15) if nl > 1 else n_smooth
            return self._smooth(li, x, b, sweeps)
        x = self._smooth(li, x, b, n_smooth)
        r = rnd(b - self.A[li] @ x)
        bc = rnd(self.P[li].T @ r)
        e = self.cycle(li + 1, np.zeros_like(bc), bc)
        if cfg.get("cycle_type", "v") == "w" and li < 2:
            e = self.cycle(li + 1, e, bc)
        x = rnd(x + rnd(self.P[li] @ e))
        return self._smooth(li, x, b, n_smooth)

    def step(self, T_prev: np.ndarray) -> np.ndarray:
        """One time step from T_prev (flat): n_multigrid cycles on the
        implicit system from x = T_prev."""
        rnd = self.rnd
        b = rnd(dg.rhs(self.levels[0], T_prev, self.cfg["dt"]))
        x = rnd(T_prev)
        for _ in range(self.cfg.get("n_multigrid", 2)):
            x = self.cycle(0, x, b)
        return x

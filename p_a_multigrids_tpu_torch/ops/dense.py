"""Dense and banded solver kit (port of the JAX package's ``ops/dense.py``).

Counterpart of the reference's LinearSolvers.F90 (not compiled into its
binary, but part of the documented solver inventory: solver_gauss,
solver_Thomas, solver_BlockThomas, fact_PLU/solver_PLU) and of
matrices.F90's FINDInv Gauss-Jordan inverse.

The same algorithms as the JAX package's, in plain PyTorch on the tensors'
own device: Gauss-Jordan elimination with partial pivoting (batched over
leading dimensions, where JAX vmaps), PLU with partial pivoting, and the
Thomas and block-Thomas recurrences (a Python loop where JAX scans; the
block solves of block-Thomas are ``gauss_solve``).  ``torch.linalg`` is
not used here: it is the tests' yardstick.  No module of either package
calls these on a solve path; they are not TPU kernels.
"""

from __future__ import annotations

import torch


def _gj_eliminate(M: torch.Tensor, n: int) -> torch.Tensor:
    """Gauss-Jordan elimination with partial pivoting on augmented
    (B, n, n + k) matrices, one step per pivot column: the strongest
    |M[i, k]| of the rows i >= k is swapped into row k (the first of equal
    ones, as argmax gives it), row k is normalized, and column k is
    eliminated from every other row by a whole-row rank-1 update."""
    B = M.shape[0]
    rows = torch.arange(n, device=M.device)
    batch = torch.arange(B, device=M.device)
    for k in range(n):
        cand = torch.where(rows >= k, M[:, :, k].abs(),
                           torch.full_like(M[:, :, k], -float("inf")))
        p = cand.argmax(dim=1)                                   # (B,)
        perm = rows.repeat(B, 1)
        perm[:, k] = p
        perm[batch, p] = k
        M = torch.gather(M, 1, perm[:, :, None].expand_as(M))
        pivot_row = M[:, k] / M[:, k, k, None]                   # (B, n + k)
        upd = M[:, :, k, None] * pivot_row[:, None, :]
        M = M - torch.where((rows == k)[None, :, None], 0.0, upd)
        M[:, k] = pivot_row
    return M


def gauss_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve by Gauss-Jordan with partial pivoting (solver_gauss /
    solver_GaussP).

    A (..., n, n); b (..., n) or (..., n, k); leading batch dimensions run
    together through the elimination loop.
    """
    n = A.shape[-1]
    vec = b.ndim == A.ndim - 1
    b2 = b[..., None] if vec else b
    k = b2.shape[-1]
    M = torch.cat([A.reshape(-1, n, n),
                   b2.to(A.dtype).reshape(-1, n, k)], dim=2)
    x = _gj_eliminate(M, n)[:, :, n:].reshape(b2.shape)
    return x[..., 0] if vec else x


def invert(A: torch.Tensor) -> torch.Tensor:
    """Dense inverse by Gauss-Jordan (replaces FINDInv); leading batch
    dimensions run together through the loop."""
    n = A.shape[-1]
    flat = A.reshape(-1, n, n)
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand_as(flat)
    return _gj_eliminate(torch.cat([flat, eye], dim=2),
                         n)[:, :, n:].reshape(A.shape)


def lu_factor(A: torch.Tensor):
    """PLU factorization with partial pivoting (fact_PLU) by whole-column
    updates.

    Returns (LU, piv): LU packs unit-lower L below the diagonal and U on /
    above it; piv[k] is the row swapped into position k at step k.
    """
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    M = A.clone()
    piv = torch.zeros(n, dtype=torch.int64, device=A.device)
    for k in range(n):
        cand = torch.where(rows >= k, M[:, k].abs(),
                           torch.full_like(M[:, k], -float("inf")))
        p = int(cand.argmax())
        perm = rows.clone()
        perm[k], perm[p] = p, k
        M = M[perm]
        piv[k] = p
        below = rows > k
        l = torch.where(below, M[:, k] / M[k, k], 0.0)
        # rank-1 update of the TRAILING submatrix only: columns < k hold
        # the stored L factors
        upd = below[:, None] & (rows[None, :] > k)
        M = M - torch.where(upd, l[:, None] * M[k][None, :], 0.0)
        M[:, k] = torch.where(below, l, M[:, k])
    return M, piv


def lu_solve(factors, b: torch.Tensor) -> torch.Tensor:
    """Forward / backward substitution against lu_factor's packed output
    (solver_PLU with its Forward / Backward sweeps)."""
    M, piv = factors
    n = M.shape[-1]
    rows = torch.arange(n, device=M.device)
    y = torch.as_tensor(b, device=M.device).to(M.dtype).clone()
    for k in range(n):
        p = int(piv[k])
        y[k], y[p] = y[p].clone(), y[k].clone()
    for i in range(n):
        Lrow = torch.where(rows < i, M[i], 0.0)
        y[i] = y[i] - Lrow @ y
    for i in range(n - 1, -1, -1):
        Urow = torch.where(rows > i, M[i], 0.0)
        y[i] = (y[i] - Urow @ y) / M[i, i]
    return y


def thomas(lower: torch.Tensor, diag: torch.Tensor, upper: torch.Tensor,
           rhs: torch.Tensor) -> torch.Tensor:
    """Tridiagonal solve via the Thomas algorithm (solver_Thomas).

    Args:
      lower: (n,) sub-diagonal (lower[0] unused)
      diag:  (n,) main diagonal
      upper: (n,) super-diagonal (upper[-1] unused)
      rhs:   (n,) or (n, k)
    """
    n = diag.shape[0]
    rhs2 = rhs if rhs.ndim > 1 else rhs[:, None]
    cp_prev = torch.zeros((), dtype=diag.dtype, device=diag.device)
    dp_prev = torch.zeros(rhs2.shape[1], dtype=rhs2.dtype,
                          device=rhs2.device)
    cps, dps = [], []
    for i in range(n):
        denom = diag[i] - lower[i] * cp_prev
        cp_prev = upper[i] / denom
        dp_prev = (rhs2[i] - lower[i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    x_next = torch.zeros_like(dp_prev)
    sol = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        sol[i] = x_next
    sol = torch.stack(sol)
    return sol if rhs.ndim > 1 else sol[:, 0]


def block_thomas(lower: torch.Tensor, diag: torch.Tensor,
                 upper: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Block-tridiagonal solve (solver_BlockThomas), each block solve by
    ``gauss_solve``.

    Args:
      lower/diag/upper: (n, b, b) block bands (lower[0], upper[-1] unused)
      rhs: (n, b)
    """
    n, b = diag.shape[0], diag.shape[-1]
    Cp_prev = torch.zeros((b, b), dtype=diag.dtype, device=diag.device)
    Dp_prev = torch.zeros(b, dtype=rhs.dtype, device=rhs.device)
    Cps, Dps = [], []
    for i in range(n):
        denom = diag[i] - lower[i] @ Cp_prev
        Cp_prev = gauss_solve(denom, upper[i])
        Dp_prev = gauss_solve(denom, rhs[i] - lower[i] @ Dp_prev)
        Cps.append(Cp_prev)
        Dps.append(Dp_prev)
    x_next = torch.zeros_like(Dp_prev)
    sol = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = Dps[i] - Cps[i] @ x_next
        sol[i] = x_next
    return torch.stack(sol)

"""Relaxation smoothers over abstract operators (from the JAX package's
``ops/smoothers.py``).

The reference's solver menu: weighted Jacobi, two-color Gauss-Seidel (the
up/down orientation of the children colors the intra-macro adjacency),
Richardson, and block-Jacobi with pre-inverted 3x3 blocks, with the
Chebyshev schedule that accelerates the block-Jacobi sweep.  Each smoother
takes ``apply_A: x -> A x`` (an affine operator is fine: Dirichlet ghost
terms may be folded in) and runs on whatever device its tensors are on;
``jax.lax.scan`` is a Python loop here.  On the stencil path the solver's
``apply_A`` is a zero-round phase of kernel K1 (``ops/phase.py``); the
Chebyshev and block-Jacobi sweeps of that path run as whole K1 phases
instead.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def chebyshev_roots(lam_max: float, degree: int,
                    lower: float = 0.1) -> list[float]:
    """Chebyshev roots of the smoothing interval [lower*lam, lam] for the
    product-form sweep x <- x + (1/r_k) M^-1 (b - A x), interleaved
    large/small so intermediate amplification stays bounded in f32."""
    a_, b_ = lower * lam_max, lam_max
    ks = np.arange(1, degree + 1)
    roots = (0.5 * (b_ + a_)
             + 0.5 * (b_ - a_) * np.cos(np.pi * (2 * ks - 1) / (2 * degree)))
    order: list[float] = []
    lo, hi = 0, degree - 1
    while lo <= hi:
        order.append(float(roots[lo]))
        lo += 1
        if lo <= hi:
            order.append(float(roots[hi]))
            hi -= 1
    return order


def chebyshev(apply_A: Callable, b: torch.Tensor, x: torch.Tensor,
              solve_prec: Callable, roots: list[float],
              sweeps: int = 1) -> torch.Tensor:
    """Chebyshev-accelerated relaxation: for each root r_k,
    x <- x + (1/r_k) P^-1 (b - A x), with P the (block-)preconditioner
    applied by ``solve_prec``."""
    for _ in range(sweeps):
        for r in roots:
            x = x + solve_prec(b - apply_A(x)) / r
    return x


def block_jacobi_solve(apply_A: Callable, b: torch.Tensor, x: torch.Tensor,
                       solve_prec: Callable, omega: float = 1.0,
                       sweeps: int = 1) -> torch.Tensor:
    """Block-Jacobi: x <- x + omega * P^-1 (b - A x), P^-1 applied by
    ``solve_prec`` (the solver's exact block inverses in its transposed
    layout)."""
    for _ in range(sweeps):
        x = x + omega * solve_prec(b - apply_A(x))
    return x


def block_jacobi_inv(apply_A: Callable, b: torch.Tensor, x: torch.Tensor,
                     inv_blocks: torch.Tensor, omega: float = 1.0,
                     sweeps: int = 1) -> torch.Tensor:
    """``block_jacobi_solve`` with pre-inverted diagonal blocks inv_blocks
    (..., nloc, nloc), matching x (..., nloc)."""
    return block_jacobi_solve(
        apply_A, b, x,
        lambda r: torch.einsum("...ij,...j->...i", inv_blocks, r),
        omega, sweeps)


def block_jacobi(apply_A: Callable, b: torch.Tensor, x: torch.Tensor,
                 diag_blocks: torch.Tensor, omega: float = 1.0,
                 sweeps: int = 1) -> torch.Tensor:
    """``block_jacobi_solve`` with exact dense solves of diag_blocks (...,
    nloc, nloc), matching x (..., nloc)."""
    return block_jacobi_solve(
        apply_A, b, x,
        lambda r: torch.linalg.solve(diag_blocks, r[..., None])[..., 0],
        omega, sweeps)


def jacobi(apply_A: Callable, b: torch.Tensor, x: torch.Tensor,
           diag: torch.Tensor, omega: float = 0.8,
           sweeps: int = 1) -> torch.Tensor:
    """Damped point Jacobi: x <- x + omega / diag * (b - A x)."""
    for _ in range(sweeps):
        x = x + omega / diag * (b - apply_A(x))
    return x


def richardson(apply_A: Callable, b: torch.Tensor, x: torch.Tensor,
               omega: float = 0.8, sweeps: int = 1) -> torch.Tensor:
    """x <- x + omega * (b - A x)."""
    for _ in range(sweeps):
        x = x + omega * (b - apply_A(x))
    return x


def colored_gs(apply_A: Callable, b: torch.Tensor, x: torch.Tensor,
               diag: torch.Tensor, color_masks, omega: float = 0.8,
               sweeps: int = 1) -> torch.Tensor:
    """Multi-color Gauss-Seidel: one color at a time, each color seeing the
    freshly updated values of the colors swept before it (one operator
    apply a color).  color_masks: boolean masks broadcastable to x that
    partition the rows."""
    for _ in range(sweeps):
        for mask in color_masks:
            x = torch.where(mask, x + omega / diag * (b - apply_A(x)), x)
    return x

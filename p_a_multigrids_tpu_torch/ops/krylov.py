"""Preconditioned conjugate gradients (port of ``pcg`` in the JAX package's
``ops/krylov.py``).

The iteration, the stopping rule ``||r|| > tol * max(||b||, 1e-30)``, the
breakdown flag ``ok`` and ``_safe_div`` are those of the JAX version, so the
two take the same number of iterations.  The loop runs on the host: the
stop condition is read back from the device once per iteration.
"""

from __future__ import annotations

from typing import Callable

import torch


def _dot(a, b):
    return torch.sum(a * b)


def _safe_div(a, b):
    """a / b, but 0 where the denominator is (near-)zero or non-finite."""
    bad = (b.abs() < torch.finfo(b.dtype).tiny * 1e3) | ~torch.isfinite(b)
    return torch.where(bad, torch.zeros_like(a),
                       a / torch.where(bad, torch.ones_like(b), b))


def pcg(apply_A: Callable, b, x0, precond: Callable | None = None,
        tol: float = 1e-8, maxiter: int = 200):
    """Preconditioned CG for SPD systems.

    Returns (x, iterations, final_residual_norm)."""
    M = precond or (lambda r: r)
    bnorm = torch.sqrt(_dot(b, b))
    atol = tol * torch.clamp(bnorm, min=1e-30)

    x = x0
    r = b - apply_A(x0)
    z = M(r)
    p = z
    rz = _dot(r, z)
    ok = True
    it = 0
    while it < maxiter and ok and bool(torch.sqrt(_dot(r, r)) > atol):
        Ap = apply_A(p)
        pAp = _dot(p, Ap)
        alpha = _safe_div(rz, pAp)
        # <p, Ap> <= 0 means A (or M) is not SPD on this subspace: a true
        # CG breakdown; freeze the iterate and stop instead of diverging
        ok = bool((pAp > 0) & torch.isfinite(alpha))
        if not ok:
            alpha = torch.zeros_like(alpha)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = _safe_div(rz_new, rz)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it, torch.sqrt(_dot(r, r))

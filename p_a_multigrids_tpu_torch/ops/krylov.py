"""Preconditioned Krylov solvers (port of ``pcg`` and ``bicgstab`` in the
JAX package's ``ops/krylov.py``).

The iterations, the stopping rules (``||r|| > tol * max(||b||, 1e-30)``),
PCG's breakdown flag ``ok``, BiCGStab's Lanczos restart, step rejection and
best-iterate bookkeeping, and ``_safe_div`` are those of the JAX versions,
so the two packages take the same number of iterations.  The loops run on
the host.  Each read of a device condition is one ``tracing.sync`` of a
flag computed beforehand (counted in ``host_syncs``, the span
``pamg.sync`` while a profiler records): PCG reads twice an iteration (the
stop rule and the breakdown flag) and once more at exit, BiCGStab once an
iteration and once at exit; everything else stays in device scalars
(``torch.where``).  A whole solve is the span ``pamg.krylov``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils import tracing


def _dot(a, b):
    return torch.sum(a * b)


def _safe_div(a, b):
    """a / b, but 0 where the denominator is (near-)zero or non-finite."""
    bad = (b.abs() < torch.finfo(b.dtype).tiny * 1e3) | ~torch.isfinite(b)
    return torch.where(bad, torch.zeros_like(a),
                       a / torch.where(bad, torch.ones_like(b), b))


def pcg(apply_A: Callable, b, x0, precond: Callable | None = None,
        tol: float = 1e-8, maxiter: int = 200, dot: Callable = _dot):
    """Preconditioned CG for SPD systems.  ``dot`` is the inner product
    (a distributed solver passes one summed over its ranks).  The search
    direction starts as ``precond(r)``'s result and is still read after
    the next call, so ``precond`` must return a tensor that its next call
    does not overwrite (``SemiSolver._precond_t`` copies its graph's
    output).

    Returns (x, iterations, final_residual_norm)."""
    with tracing.span("pamg.krylov"):
        M = precond or (lambda r: r)
        bnorm = torch.sqrt(dot(b, b))
        atol = tol * torch.clamp(bnorm, min=1e-30)

        x = x0
        r = b - apply_A(x0)
        z = M(r)
        p = z
        rz = dot(r, z)
        ok = True
        it = 0
        while it < maxiter and ok and tracing.sync(
                torch.sqrt(dot(r, r)) > atol):
            Ap = apply_A(p)
            pAp = dot(p, Ap)
            alpha = _safe_div(rz, pAp)
            # <p, Ap> <= 0 means A (or M) is not SPD on this subspace: a
            # true CG breakdown; freeze the iterate and stop instead of
            # diverging
            ok = tracing.sync((pAp > 0) & torch.isfinite(alpha))
            if not ok:
                alpha = torch.zeros_like(alpha)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = dot(r, z)
            beta = _safe_div(rz_new, rz)
            p = z + beta * p
            rz = rz_new
            it += 1
        return x, it, torch.sqrt(dot(r, r))


def bicgstab(apply_A: Callable, b, x0, precond: Callable | None = None,
             tol: float = 1e-8, maxiter: int = 200, dot: Callable = _dot):
    """Preconditioned BiCGStab for nonsymmetric (advective) systems.

    When the shadow product rho = <rhat, r> degenerates (|rho| < 1e-12
    |<r, r>|) the shadow residual is re-anchored at r (a restart); a step
    whose residual is non-finite or above 1e4 x the best one so far is
    rejected and forces a restart.  Returns (x_best, iterations, rn_best):
    the iterate of smallest residual norm, not the last one.  ``dot`` is
    the inner product, and ``precond`` returns tensors that its next call
    leaves alone, as in ``pcg``."""
    with tracing.span("pamg.krylov"):
        M = precond or (lambda r: r)
        bnorm = torch.sqrt(dot(b, b))
        atol = tol * torch.clamp(bnorm, min=1e-30)

        r = b - apply_A(x0)
        x, rhat = x0, r
        rn_best = torch.sqrt(dot(r, r))
        one = torch.ones((), dtype=b.dtype, device=b.device)
        rho = alpha = omega = one
        v = p = torch.zeros_like(b)
        x_best = x0
        it = 0
        while it < maxiter and tracing.sync(
                (rn_best > atol) & (torch.sqrt(dot(r, r)) > atol)):
            rho_new = dot(rhat, r)
            rr = dot(r, r)
            # Lanczos breakdown (|<rhat, r>| << |r|^2): restart with
            # rhat = r
            restart = rho_new.abs() < 1e-12 * rr.abs()
            rhat = torch.where(restart, r, rhat)
            rho_new = torch.where(restart, rr, rho_new)
            beta = torch.where(restart, torch.zeros_like(rho_new),
                               _safe_div(rho_new, rho)
                               * _safe_div(alpha, omega))
            v = torch.where(restart, torch.zeros_like(v), v)
            p = r + beta * (p - omega * v)
            phat = M(p)
            v = apply_A(phat)
            alpha = _safe_div(rho_new, dot(rhat, v))
            s = r - alpha * v
            shat = M(s)
            t = apply_A(shat)
            omega = _safe_div(dot(t, s), dot(t, t))
            x_n = x + alpha * phat + omega * shat
            r_n = s - omega * t
            rn_n = torch.sqrt(dot(r_n, r_n))
            # step rejection: a non-finite or exploding step (> 1e4 x the
            # best residual so far, far beyond BiCGStab's normal
            # nonmonotonicity) keeps the previous iterate and forces a
            # clean restart next round
            bad = ~torch.isfinite(rn_n) | (
                rn_n > 1e4 * torch.maximum(rn_best, atol))
            x = torch.where(bad, x, x_n)
            r = torch.where(bad, r, r_n)
            v = torch.where(bad, torch.zeros_like(v), v)
            p = torch.where(bad, torch.zeros_like(p), p)
            rhat = torch.where(bad, r, rhat)
            alpha = torch.where(bad, one, alpha)
            omega = torch.where(bad, one, omega)
            rho = torch.where(bad, one, rho_new)
            rn_cur = torch.where(bad, torch.sqrt(dot(r, r)), rn_n)
            better = rn_cur < rn_best
            x_best = torch.where(better, x, x_best)
            rn_best = torch.where(better, rn_cur, rn_best)
            it += 1
        return x_best, it, rn_best

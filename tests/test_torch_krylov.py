"""The port's Krylov solvers == the JAX package's, float64 on the CPU.

The four BiCGStab systems of tests/test_krylov.py (a random nonsymmetric
matrix, a singular preconditioner, a nearly skew operator and the
preconditioned advective shape).  BiCGStab's Lanczos product rho = <rhat, r>
cancels: on the skew system |rho| / |r|^2 falls to 3e-9 by iteration 5, so
the rounding of two summation orders of one dot product (numpy/torch
against XLA) grows by up to 1e8 in one iteration, and the two packages'
iterates part after 3 (skew), 10 (random) or 15 (singular preconditioner)
iterations, measured.  So each system is held iterate for iterate, x to
1e-12 and the best residual norm, over the iterations where both stay well
conditioned; the full solve then takes the same number of iterations in
both packages, keeps the JAX package's guarantees (finite, never above the
starting residual), and reaches the true solution where it converges.  PCG
is held to 1e-12 on an SPD system.
"""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu.ops import krylov as jkrylov

from p_a_multigrids_tpu_torch.ops import krylov


def _skew(n):
    S = np.zeros((n, n))
    for i in range(n - 1):
        S[i, i + 1], S[i + 1, i] = 1.0, -1.0
    return S


def _nonsymmetric():
    rng = np.random.default_rng(2)
    n = 40
    A = np.eye(n) * 4.0 + 0.8 * rng.normal(size=(n, n))
    return A, A @ rng.normal(size=n), None, 1e-12, 400


def _singular_precond():
    rng = np.random.default_rng(4)
    n = 30
    A = np.eye(n) * 3.0 + 0.5 * rng.normal(size=(n, n))
    mask = (np.arange(n) < n // 2).astype(np.float64)
    return A, rng.normal(size=n), np.diag(mask), 1e-10, 200


def _skew_dominated():
    n = 24
    A = np.eye(n) * 0.05 + _skew(n)
    return (A, A @ np.random.default_rng(5).normal(size=n), None, 1e-10,
            2000)


def _advective_preconditioned():
    n = 24
    A = np.eye(n) * 0.05 + _skew(n)
    Minv = np.linalg.inv(A + 0.3 * np.eye(n))
    return (A, A @ np.random.default_rng(6).normal(size=n), Minv, 1e-10,
            500)


SYSTEMS = {"nonsymmetric": _nonsymmetric,
           "singular_precond": _singular_precond,
           "skew_dominated": _skew_dominated,
           "advective_preconditioned": _advective_preconditioned}
# iterations over which the two packages' iterates agree to 1e-12 (above)
AGREE = {"nonsymmetric": 10, "singular_precond": 15, "skew_dominated": 3,
         "advective_preconditioned": 500}


def _both(method, A, b, P, tol, maxiter):
    """(JAX result, port result) of ``method`` on A x = b from x0 = 0,
    preconditioned by the matrix P when given."""
    Aj, Pj = jnp.asarray(A), None if P is None else jnp.asarray(P)
    want = getattr(jkrylov, method)(
        lambda v: Aj @ v, jnp.asarray(b), jnp.zeros(len(b)),
        precond=None if P is None else (lambda r: Pj @ r), tol=tol,
        maxiter=maxiter)
    At, Pt = torch.tensor(A), None if P is None else torch.tensor(P)
    bt = torch.tensor(b)
    got = getattr(krylov, method)(
        lambda v: At @ v, bt, torch.zeros_like(bt),
        precond=None if P is None else (lambda r: Pt @ r), tol=tol,
        maxiter=maxiter)
    return want, got


@pytest.mark.parametrize("system", list(SYSTEMS))
def test_bicgstab_matches_jax(system):
    A, b, P, tol, maxiter = SYSTEMS[system]()
    (xj, itj, rnj), (xt, itt, rnt) = _both("bicgstab", A, b, P, tol,
                                           min(AGREE[system], maxiter))
    assert itt == int(itj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12,
                               atol=1e-12)
    assert float(rnt) == pytest.approx(float(rnj), rel=1e-12, abs=1e-14)
    (xj, itj, rnj), (xt, itt, rnt) = _both("bicgstab", A, b, P, tol,
                                           maxiter)
    assert itt == int(itj)
    # the JAX package's guarantees: finite, and the best iterate is never
    # worse than x0 = 0
    assert bool(torch.isfinite(xt).all()) and np.isfinite(float(rnt))
    assert float(rnt) <= float(np.linalg.norm(b)) * (1 + 1e-9)
    if system in ("nonsymmetric", "advective_preconditioned"):
        x_true = np.linalg.solve(A, b)
        np.testing.assert_allclose(xt.numpy(), x_true, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(xj), x_true, rtol=1e-9,
                                   atol=1e-9)


def test_bicgstab_zero_rhs_takes_no_iteration():
    A, _, _, _, _ = _nonsymmetric()
    x, it, rn = krylov.bicgstab(lambda v: torch.tensor(A) @ v,
                                torch.zeros(40, dtype=torch.float64),
                                torch.zeros(40, dtype=torch.float64))
    assert it == 0 and float(rn) == 0.0 and not bool(x.any())


def test_pcg_matches_jax():
    rng = np.random.default_rng(0)
    Q = np.linalg.qr(rng.normal(size=(40, 40)))[0]
    A = Q @ np.diag(rng.uniform(0.5, 10.0, 40)) @ Q.T
    b = A @ rng.normal(size=40)
    (xj, itj, rnj), (xt, itt, rnt) = _both("pcg", A, b, None, 1e-12, 200)
    assert itt == int(itj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12,
                               atol=1e-12)

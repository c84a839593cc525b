"""The port's smoothers (ops/smoothers.py) == the JAX package's, float64 on
the CPU, on a small SPD system: each relaxation over the same operator
callable, right-hand side and start gives the same iterate to 1e-12."""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu.ops import smoothers as jsm

from p_a_multigrids_tpu_torch.ops import smoothers as tsm

N_BLK, NLOC = 6, 3                      # 6 blocks of 3 unknowns


def _system(seed=0):
    """A (18, 18) SPD matrix with a dominant block diagonal, its diagonal,
    its block inverses, b, x0 and a two-color partition of the blocks."""
    rng = np.random.default_rng(seed)
    n = N_BLK * NLOC
    G = rng.normal(size=(n, n))
    A = G @ G.T / n + 4.0 * np.eye(n)
    blocks = np.stack([A[i * 3:i * 3 + 3, i * 3:i * 3 + 3]
                       for i in range(N_BLK)])
    b = rng.normal(size=(N_BLK, NLOC))
    x0 = rng.normal(size=(N_BLK, NLOC))
    colors = (np.arange(N_BLK) % 2 == 0)[:, None]
    return A, np.diagonal(A).reshape(N_BLK, NLOC), np.linalg.inv(blocks), \
        b, x0, colors


def _run(name, A, d, Binv, b, x0, colors, lib, arr):
    """One smoother of ``lib`` on arrays made by ``arr``."""
    def apply_A(x):
        return (arr(A) @ x.reshape(-1)).reshape(x.shape)
    args = (apply_A, arr(b), arr(x0))
    if name == "chebyshev":
        # the largest eigenvalue of D^-1 A
        lam = float(np.abs(np.linalg.eigvals(
            A / np.diagonal(A)[:, None])).max())
        roots = lib.chebyshev_roots(lam, 4, 0.1)
        solve = (lambda r: r / arr(d))
        return lib.chebyshev(*args, solve, roots, 3)
    if name == "block_jacobi_inv":
        return lib.block_jacobi_inv(*args, arr(Binv), 0.8, 5)
    if name == "jacobi":
        return lib.jacobi(*args, arr(d), 0.7, 5)
    if name == "richardson":
        return lib.richardson(*args, 0.05, 5)
    mask = arr(colors)
    return lib.colored_gs(*args, arr(d), (mask, ~mask), 0.8, 5)


@pytest.mark.parametrize("name", ["chebyshev", "block_jacobi_inv", "jacobi",
                                  "richardson", "colored_gs"])
def test_smoother_matches_jax(name):
    system = _system()
    want = np.asarray(_run(name, *system, jsm, jnp.asarray))
    got = _run(name, *system, tsm, torch.tensor).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # and the smoother relaxes: the residual falls
    A, _, _, b, x0, _ = system
    r0 = np.abs(b.reshape(-1) - A @ x0.reshape(-1)).max()
    r1 = np.abs(b.reshape(-1) - A @ got.reshape(-1)).max()
    assert r1 < r0


"""The port's dense / banded solver kit (ops/dense.py) == the JAX
package's and numpy's solves, at tests/test_dense.py's tolerances (Thomas
1e-10, block Thomas 1e-9, Gauss-Jordan, inverse and PLU 1e-8), in float64
on the CPU; torch.linalg is the yardstick only."""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu.ops import dense as jdense

from p_a_multigrids_tpu_torch.ops import dense as tdense


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _tridiag(rng, n):
    lower = rng.normal(size=n)
    upper = rng.normal(size=n)
    diag = np.abs(rng.normal(size=n)) + 4.0   # diagonally dominant
    A = np.diag(diag) + np.diag(lower[1:], -1) + np.diag(upper[:-1], 1)
    return lower, diag, upper, A


@pytest.mark.parametrize("k", [None, 4], ids=["vector", "matrix"])
def test_thomas(k):
    rng = np.random.default_rng(0 if k is None else 1)
    n = 17 if k is None else 9
    lower, diag, upper, A = _tridiag(rng, n)
    b = rng.normal(size=n if k is None else (n, k))
    got = tdense.thomas(_t(lower), _t(diag), _t(upper), _t(b)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(A, b), rtol=1e-10)
    want = np.asarray(jdense.thomas(jnp.asarray(lower), jnp.asarray(diag),
                                    jnp.asarray(upper), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_block_thomas():
    rng = np.random.default_rng(2)
    n, b = 6, 3
    lower = rng.normal(size=(n, b, b)) * 0.2
    upper = rng.normal(size=(n, b, b)) * 0.2
    diag = rng.normal(size=(n, b, b)) * 0.2 + 3.0 * np.eye(b)
    rhs = rng.normal(size=(n, b))
    A = np.zeros((n * b, n * b))
    for i in range(n):
        A[i * b:(i + 1) * b, i * b:(i + 1) * b] = diag[i]
        if i > 0:
            A[i * b:(i + 1) * b, (i - 1) * b:i * b] = lower[i]
        if i < n - 1:
            A[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = upper[i]
    got = tdense.block_thomas(_t(lower), _t(diag), _t(upper),
                              _t(rhs)).numpy()
    np.testing.assert_allclose(got.reshape(-1),
                               np.linalg.solve(A, rhs.reshape(-1)),
                               rtol=1e-9)
    want = np.asarray(jdense.block_thomas(
        jnp.asarray(lower), jnp.asarray(diag), jnp.asarray(upper),
        jnp.asarray(rhs)))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def _system(seed=3):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(5, 7, 7)) + 7 * np.eye(7)
    b = rng.normal(size=(5, 7))
    return A, b, np.linalg.solve(A, b[..., None])[..., 0]


def test_gauss_solve():
    A, b, want = _system()
    got = tdense.gauss_solve(_t(A), _t(b[..., None])).numpy()[..., 0]
    np.testing.assert_allclose(got, want, rtol=1e-8)
    np.testing.assert_allclose(tdense.gauss_solve(_t(A), _t(b)).numpy(),
                               want, rtol=1e-8)
    np.testing.assert_allclose(tdense.gauss_solve(_t(A[1]), _t(b[1])).numpy(),
                               want[1], rtol=1e-8)
    jgot = np.asarray(jdense.gauss_solve(jnp.asarray(A),
                                         jnp.asarray(b[..., None])))[..., 0]
    np.testing.assert_allclose(got, jgot, rtol=1e-8)


def test_invert():
    A, b, want = _system()
    inv = tdense.invert(_t(A)).numpy()
    np.testing.assert_allclose(np.einsum("bij,bj->bi", inv, b), want,
                               rtol=1e-8)
    np.testing.assert_allclose(inv, np.asarray(jdense.invert(jnp.asarray(A))),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tdense.invert(_t(A[0])).numpy(),
                               torch.linalg.inv(_t(A[0])).numpy(),
                               rtol=1e-8, atol=1e-12)


def test_lu_factor_and_solve():
    A, b, want = _system()
    f = tdense.lu_factor(_t(A[0]))
    np.testing.assert_allclose(tdense.lu_solve(f, _t(b[0])).numpy(), want[0],
                               rtol=1e-8)
    jf = jdense.lu_factor(jnp.asarray(A[0]))
    np.testing.assert_allclose(f[0].numpy(), np.asarray(jf[0]), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_array_equal(f[1].numpy(), np.asarray(jf[1]))
    np.testing.assert_allclose(tdense.lu_solve(f, _t(b[0])).numpy(),
                               np.asarray(jdense.lu_solve(jf, b[0])),
                               rtol=1e-8)


def test_partial_pivoting_reorders_rows():
    """A zero leading pivot is swapped away, as in the JAX package."""
    A = np.array([[0.0, 2.0, 1.0], [3.0, 1.0, 0.0], [1.0, 0.0, 4.0]])
    b = np.array([1.0, 2.0, 3.0])
    want = np.linalg.solve(A, b)
    np.testing.assert_allclose(tdense.gauss_solve(_t(A), _t(b)).numpy(),
                               want, rtol=1e-12)
    LU, piv = tdense.lu_factor(_t(A))
    assert int(piv[0]) == 1
    np.testing.assert_allclose(tdense.lu_solve((LU, piv), _t(b)).numpy(),
                               want, rtol=1e-12)

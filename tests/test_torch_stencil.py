"""The port's StencilOperator (direct index gathers) == the JAX package's
(one-hot matmul gathers), float64 on the CPU."""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.ops import stencil as jstencil

from p_a_multigrids_tpu_torch.ops import stencil as tstencil
from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t

TOL = dict(rtol=1e-12, atol=1e-12)


def _ops(n_split, advection, li=0):
    phys = jcfg.Physics(advection=advection,
                        u=(0.4, -0.2) if advection else (0.0, 0.0))
    cfg = jcfg.SemiConfig(n_split=n_split, multi_levels=2, dt=0.05,
                          dtype="float64", physics=phys)
    L = jsemi.build_problem(jstruct.tri_mesh(6, 3, 0.3, 0.2), cfg).levels[li]
    data = jstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    t_data = tstencil.StencilData(**vars(data))
    return (jstencil.StencilOperator(data, np.float64),
            tstencil.StencilOperator(t_data, torch.float64, "cpu"))


@pytest.mark.parametrize("with_bc", [False, True])
@pytest.mark.parametrize("advection", [False, True])
@pytest.mark.parametrize("n_split,li", [(2, 0), (2, 1), (3, 0)])
def test_apply_z_solve_diag(n_split, li, advection, with_bc):
    jop, top = _ops(n_split, advection, li)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, jop.C, jop.U))
    b = rng.normal(size=(3, jop.C, jop.U))
    xt, bt = torch.tensor(x), torch.tensor(b)
    np.testing.assert_allclose(top.apply(xt, with_bc).numpy(),
                               np.asarray(jop.apply(jnp.asarray(x), with_bc)),
                               **TOL)
    bp_j = jop._bp(jnp.asarray(b), with_bc)
    bp_t = top._bp(bt, with_bc)
    np.testing.assert_allclose(bp_t.numpy(), np.asarray(bp_j), **TOL)
    np.testing.assert_allclose(top._z(xt, bp_t).numpy(),
                               np.asarray(jop._z(jnp.asarray(x), bp_j)),
                               **TOL)
    np.testing.assert_allclose(top.solve_diag(bt).numpy(),
                               np.asarray(jop.solve_diag(jnp.asarray(b))),
                               **TOL)
    # mul_self undoes solve_diag
    np.testing.assert_allclose(top.mul_self(top.solve_diag(bt)).numpy(), b,
                               **TOL)


def test_layout_roundtrip():
    rng = np.random.default_rng(0)
    T = torch.tensor(rng.normal(size=(5, 4, 3)))
    Tt = to_t(T)
    assert Tt.shape == (3, 4, 5) and Tt.is_contiguous()
    assert torch.equal(Tt[2, 1], T[:, 1, 2])
    assert torch.equal(from_t(Tt), T)


def test_rejects_packed_data():
    """The port runs coarse levels unpacked: packed data is refused."""
    cfg = jcfg.SemiConfig(n_split=1, multi_levels=1, dt=0.05,
                          dtype="float64")
    L = jsemi.build_problem(jstruct.tri_mesh(4, 4, 0.25, 0.25),
                            cfg).levels[0]
    packed = jstencil.pack_stencil(
        jstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta), 4)
    with pytest.raises(ValueError, match="packed"):
        tstencil.StencilOperator(tstencil.StencilData(**vars(packed)),
                                 torch.float64, "cpu")

"""Relaxation phase: the port's phase_reference == the JAX package's TPU
kernel K1 (PhaseOperatorCoefResident, Pallas interpret mode) on a
lane-tileable mesh (U = 128), float64.  The CUDA kernel is held against
phase_reference in tests/test_torch_cuda.py, which imports no JAX so that
it runs on a GPU machine.

Tolerances are those of tests/test_pallas.py: x to 1e-12, mul_self(z) to
1e-11.
"""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.ops import pallas_stencil as jps
from p_a_multigrids_tpu.ops import stencil as jstencil

from p_a_multigrids_tpu_torch.ops import phase as tphase
from p_a_multigrids_tpu_torch.ops import smoothers as tsmooth
from p_a_multigrids_tpu_torch.ops import stencil as tstencil

MESH = (16, 4, 0.25, 0.25)                  # U = 128


@pytest.fixture(scope="module")
def level():
    """JAX phase kernel (interpret) and the port's operator, one level."""
    phys = jcfg.Physics(advection=True, u=(0.3, 0.1))
    cfg = jcfg.SemiConfig(n_split=2, multi_levels=1, dt=0.05,
                          dtype="float64", physics=phys)
    L = jsemi.build_problem(jstruct.tri_mesh(*MESH), cfg).levels[0]
    data = jstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    jop = jstencil.StencilOperator(data, np.float64)
    ph = jps.make_phase(jop, interpret=True, impl="coef_resident")
    top = tstencil.StencilOperator(tstencil.StencilData(**vars(data)),
                                   torch.float64, "cpu")
    return jop, ph, top


def _inputs(op, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, op.C, op.U))
    b = rng.normal(size=(3, op.C, op.U))
    return x, b


def _cheb(top):
    return [1.0 / r for r in tsmooth.chebyshev_roots(
        tstencil.lam_max_estimate(top._data), 6, 0.1)]


@pytest.mark.parametrize("kind", ["chebyshev", "omega"])
@pytest.mark.parametrize("want_z", [True, False])
def test_phase_reference_matches_jax_kernel(level, kind, want_z):
    jop, ph, top = level
    x, b = _inputs(top, 5)
    coefs = _cheb(top) if kind == "chebyshev" else [0.8] * 3
    bp_j = jop._bp(jnp.asarray(b), True)
    xj, zj = ph.phase(jnp.asarray(x), bp_j, coefs, want_z=want_z)
    xt, zt = tphase.phase_reference(top, torch.tensor(x),
                                    top._bp(torch.tensor(b), True), coefs,
                                    want_z)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12,
                               atol=1e-12)
    if want_z:
        np.testing.assert_allclose(top.mul_self(zt).numpy(),
                                   np.asarray(ph.mul_self(zj)),
                                   rtol=1e-11, atol=1e-11)
    else:
        assert zt is None


def test_zero_round_apply_matches_jax_kernel(level):
    """No rounds + z: z = -D^-1 A x, so -mul_self(z) = A x."""
    jop, ph, top = level
    x, _ = _inputs(top, 6)
    zero = np.zeros_like(x)
    _, zj = ph.phase(jnp.asarray(x), jnp.asarray(zero), [])
    xt, zt = tphase.phase_reference(top, torch.tensor(x),
                                    torch.tensor(zero), [])
    assert torch.equal(xt, torch.tensor(x))
    np.testing.assert_allclose(top.mul_self(zt).numpy(),
                               np.asarray(ph.mul_self(zj)), rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(-top.mul_self(zt).numpy(),
                               np.asarray(jop.apply(jnp.asarray(x), False)),
                               rtol=1e-11, atol=1e-11)


def test_phase_on_cpu_is_the_plain_version(level):
    """A CPU tensor runs phase_reference and launches nothing; the wrapper
    checks shape and contiguity on every device."""
    _, _, top = level
    x, b = (torch.tensor(a) for a in _inputs(top, 7))
    n0 = tphase.KERNEL.launches
    got = tphase.phase(top, x, b, [0.8, 0.7])
    ref = tphase.phase_reference(top, x, b, [0.8, 0.7])
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert tphase.KERNEL.launches == n0
    x_same, no_z = tphase.phase(top, x, b, [], want_z=False)
    assert x_same is x and no_z is None
    with pytest.raises(ValueError, match="shape"):
        tphase.phase(top, x[:, :-1].contiguous(), b, [0.8])
    with pytest.raises(ValueError, match="contiguous"):
        tphase.phase(top, x.transpose(1, 2).contiguous().transpose(1, 2),
                     b, [0.8])
    with pytest.raises(ValueError, match="float32"):
        tphase.phase(top, x.float(), b.float(), [0.8])


def test_round_coefs_cast_to_state_dtype():
    c = tphase._round_coefs([0.1, 1 / 3], True, torch.float32)
    assert c == [float(np.float32(0.1)), float(np.float32(1 / 3)), 0.0]
    assert tphase._round_coefs([], False, torch.float64) == []

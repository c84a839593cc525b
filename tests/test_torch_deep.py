"""The deep-split path of the port (n_split 4-5, C = 256 and 1024 children
per macro) == the JAX package's, float64 on the CPU.

- phase_reference == the JAX package's TPU kernel for C > 64,
  PhaseOperatorResident (Pallas interpret mode), at C = 256 and 1024.
  Tolerances are those of tests/test_torch_phase.py: x to 1e-12,
  mul_self(z) to 1e-11.
- The O(C) index-gather grid transfers == the JAX package's one-hot
  contractions at n_split 1-5, to 1e-13.

The V- and W-cycles of the deep path are in tests/test_torch_deep_cycles.py.
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

from p_a_multigrids_tpu_torch.models import semi as tsemi
from p_a_multigrids_tpu_torch.ops import phase as tphase
from p_a_multigrids_tpu_torch.ops import smoothers as tsmooth
from p_a_multigrids_tpu_torch.ops import stencil as tstencil

# tiny macro meshes: C = 256 on 8 macros, C = 1024 on 4
MESHES = {4: (2, 2, 0.5, 0.5), 5: (2, 1, 0.5, 0.5)}


@pytest.fixture(scope="module", params=[4, 5], ids=["C256", "C1024"])
def deep_level(request):
    """JAX resident lattice kernel (interpret) and the port's operator on
    one level at n_split 4 or 5."""
    n_split = request.param
    phys = jcfg.Physics(advection=True, u=(0.3, 0.1))
    cfg = jcfg.SemiConfig(n_split=n_split, multi_levels=1, dt=0.05,
                          dtype="float64", physics=phys)
    L = jsemi.build_problem(jstruct.tri_mesh(*MESHES[n_split]),
                            cfg).levels[0]
    data = jstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    jop = jstencil.StencilOperator(data, np.float64)
    ph = jps.make_phase(jop, interpret=True, impl="resident")
    assert type(ph).__name__ == "PhaseOperatorResident"
    top = tstencil.StencilOperator(tstencil.StencilData(**vars(data)),
                                   torch.float64, "cpu")
    assert top.C == 4 ** n_split > tphase.DEEP_C
    return jop, ph, top


def _inputs(op, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, op.C, op.U)),
            rng.normal(size=(3, op.C, op.U)))


@pytest.mark.parametrize("kind,want_z", [("chebyshev", True),
                                         ("chebyshev", False),
                                         ("omega", True), ("omega", False)])
def test_phase_reference_matches_resident_kernel(deep_level, kind, want_z):
    jop, ph, top = deep_level
    x, b = _inputs(top, 5)
    coefs = ([1.0 / r for r in tsmooth.chebyshev_roots(
        tstencil.lam_max_estimate(top._data), 6, 0.1)]
        if kind == "chebyshev" else [0.8] * 3)
    xj, zj = ph.phase(jnp.asarray(x), jop._bp(jnp.asarray(b), True), coefs,
                      want_z=want_z)
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


def test_zero_round_apply_matches_resident_kernel(deep_level):
    """No rounds + z: -mul_self(z) = A x, as the JAX kernel gives it."""
    jop, ph, top = deep_level
    x, _ = _inputs(top, 6)
    zero = np.zeros_like(x)
    _, zj = ph.phase(jnp.asarray(x), jnp.asarray(zero), [])
    _, zt = tphase.phase_reference(top, torch.tensor(x), torch.tensor(zero),
                                   [])
    np.testing.assert_allclose(top.mul_self(zt).numpy(),
                               np.asarray(ph.mul_self(zj)), rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(-top.mul_self(zt).numpy(),
                               np.asarray(jop.apply(jnp.asarray(x), False)),
                               rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5])
def test_transfers_match_jax_onehot(n_split):
    """restrict_t sums the four children fine_of[c]; prolong_t gathers
    parent[f]: the same numbers as the JAX package's (Cc, Cf) one-hot
    contractions."""
    n_c = n_split - 1
    fine_of, parent, pw = tsemi._transfer_tables(n_c)
    rng = np.random.default_rng(n_split)
    U = 3
    r = rng.normal(size=(3, 4 ** n_split, U))
    e = rng.normal(size=(3, 4 ** n_c, U))
    got_r = tsemi.restrict_t(torch.tensor(r), torch.as_tensor(
        fine_of.astype(np.int64)), torch.tensor(pw))
    got_p = tsemi.prolong_t(torch.tensor(e), torch.as_tensor(
        parent.astype(np.int64)), torch.tensor(pw))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(
        jsemi.restrict_t(jnp.asarray(r), n_c)), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(
        jsemi.prolong_t(jnp.asarray(e), n_c)), rtol=1e-13, atol=1e-13)


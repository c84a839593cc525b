"""The port's FusedOperator (the non-stencil path's operator) == the JAX
package's FusedOperator and the port's own apply_A, float64 on the CPU,
with and without the Dirichlet ghosts, for every physics toggle and with
no-flux (Neumann) faces."""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.ops import fused as jfused

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.models import semi as tsemi
from p_a_multigrids_tpu_torch.ops import fused as tfused

MESH = (3, 2, 1 / 3, 1 / 2)              # U = 12
# the physics of tests/test_fused.py
PHYSICS = {
    "diffusion": dict(),
    "advect_diffuse": dict(advection=True, u=(0.7, -0.3)),
    "advection_only": dict(diffusion=False, advection=True, u=(1.0, 0.5)),
    "penalty_only": dict(sip_consistency=False),
    "no_surface": dict(surface_terms=False),
}


def _levels(phys, n_split=2, neumann=False):
    """(JAX level 0, port level 0, port config) of one configuration."""
    kw = dict(n_split=n_split, multi_levels=1, dt=0.3, dtype="float64")
    jfns, tfns = jcfg.ProblemFns(), tcfg.ProblemFns()
    if neumann:
        for fns in (jfns, tfns):
            fns.bc = lambda x, y: np.sin(x + y)
            fns.neumann = lambda x, y: np.asarray(x) > 0.5
    jc = jcfg.SemiConfig(physics=jcfg.Physics(**phys), fns=jfns, **kw)
    tc = tcfg.SemiConfig(physics=tcfg.Physics(**phys), fns=tfns, **kw)
    jL = jsemi.build_problem(jstruct.tri_mesh(*MESH), jc).levels[0]
    tL = tsemi.build_problem(tstruct.tri_mesh(*MESH), tc).levels[0]
    return jc, jL, tc, tL


def _check(jc, jL, tc, tL, seed):
    jop = jfused.FusedOperator(jL, jc.physics, jc.dt, jc.theta)
    top = tfused.FusedOperator(tL, tc.physics, tc.dt, tc.theta,
                               device="cpu")
    Lt = tsemi.level_tensors(tL, "cpu")
    U, C = tL["M"].shape[0], tL["updown"].shape[0]
    T = np.random.default_rng(seed).normal(size=(U, C, 3))
    for with_bc in (False, True):
        got = tfused.from_t(top.apply(tfused.to_t(torch.tensor(T)),
                                      with_bc)).numpy()
        want = np.asarray(jfused.from_t(jop.apply(jfused.to_t(
            jnp.asarray(T)), with_bc)))
        ref = tsemi.apply_A(Lt, tc.physics, tc.dt, tc.theta,
                            torch.tensor(T), with_bc).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        assert np.abs(got - ref).max() < 1e-11


@pytest.mark.parametrize("phys", list(PHYSICS))
def test_fused_matches_jax_and_apply_A(phys):
    _check(*_levels(PHYSICS[phys]), seed=0)


def test_fused_with_neumann():
    """No-flux faces mirror the element's own trace in the strip."""
    _check(*_levels({}, n_split=1, neumann=True), seed=1)


def test_fused_strip_indices_are_device_int64():
    """The cross-macro strip gathers are built once, as int64 tensors: 3 *
    2**s slots a macro."""
    _, _, tc, tL = _levels({}, n_split=3)
    top = tfused.FusedOperator(tL, tc.physics, tc.dt, tc.theta,
                               device="cpu")
    assert top.nb == 3 * 2 ** 3
    for name in ("halo_idx", "halo_perm", "intra_rows", "slot_of",
                 "own_rows", "grad_rows", "bnd_c"):
        assert getattr(top, name).dtype == torch.int64, name
    assert tuple(top.halo_idx.shape) == (tL["M"].shape[0], top.nb)
    assert "halo_idx" in dict(top.named_buffers())


def test_to_t_from_t_round_trip():
    T = torch.arange(2 * 4 * 3, dtype=torch.float64).reshape(2, 4, 3)
    Tt = tfused.to_t(T)
    assert Tt.shape == (3, 4, 2) and Tt.is_contiguous()
    assert torch.equal(tfused.from_t(Tt), T)
    assert torch.equal(Tt, torch.tensor(np.asarray(
        jfused.to_t(jnp.asarray(T.numpy())))))

"""The port's matrix-free operator (``flat_gather``, ``neighbor_trace``,
``apply_spatial``, ``apply_A``, ``diag_blocks_A`` in ``models.semi``) ==
the JAX package's, float64 on the CPU, to 1e-12: the four physics of
tests/test_assembled.py and a no-flux (Neumann) mask, with and without the
Dirichlet ghosts."""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import semi as jsemi

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.models import semi as tsemi

MESH = (4, 3, 0.25, 1 / 3)
PHYSICS = {
    "diffusion": dict(diffusion=True, advection=False),
    "advection_diffusion": dict(diffusion=True, advection=True,
                                u=(0.7, -0.3)),
    "advection": dict(diffusion=False, advection=True, u=(1.0, 0.5)),
    "penalty_only": dict(diffusion=True, sip_consistency=False),
    # a face tangent to u (sign(0) in the upwind switch) and no-flux walls
    "neumann_advection": dict(diffusion=True, advection=True, u=(1.0, 0.0)),
}


def _wall(x, y):
    return np.asarray(y) > 0.5


def _levels(case, n_split=2):
    """(JAX level 0, port device tables of level 0, JAX Physics, port
    Physics)."""
    kw = PHYSICS[case]
    neu = case.startswith("neumann")
    jp, tp = jcfg.Physics(**kw), tcfg.Physics(**kw)
    jc = jcfg.SemiConfig(n_split=n_split, multi_levels=1, dt=0.3, physics=jp,
                         dtype="float64",
                         fns=jcfg.ProblemFns(neumann=_wall if neu else None))
    tc = tcfg.SemiConfig(n_split=n_split, multi_levels=1, dt=0.3,
                         physics=tp, dtype="float64",
                         fns=tcfg.ProblemFns(neumann=_wall if neu else None))
    Lj = jsemi.build_problem(jstruct.tri_mesh(*MESH), jc).levels[0]
    Lt = tsemi.level_tensors(
        tsemi.build_problem(tstruct.tri_mesh(*MESH), tc).levels[0], "cpu")
    if neu:
        assert bool(Lt["neu_mask"].any())
    return Lj, Lt, jp, tp


def _state(Lt, seed):
    U, C = Lt["M"].shape[0], Lt["updown"].shape[0]
    return np.random.default_rng(seed).normal(size=(U, C, 3))


@pytest.mark.parametrize("case", list(PHYSICS))
@pytest.mark.parametrize("with_bc", [False, True], ids=["hom", "bc"])
def test_apply_matches_jax(case, with_bc):
    Lj, Lt, jp, tp = _levels(case)
    T = _state(Lt, 0)
    np.testing.assert_allclose(
        tsemi.neighbor_trace(Lt, torch.tensor(T), with_bc).numpy(),
        np.asarray(jsemi.neighbor_trace(Lj, jnp.asarray(T), with_bc)),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tsemi.apply_spatial(Lt, tp, torch.tensor(T), with_bc).numpy(),
        np.asarray(jsemi.apply_spatial(Lj, jp, jnp.asarray(T), with_bc)),
        rtol=1e-12, atol=1e-12)
    for theta in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(
            tsemi.apply_A(Lt, tp, 0.3, theta, torch.tensor(T),
                          with_bc).numpy(),
            np.asarray(jsemi.apply_A(Lj, jp, 0.3, theta, jnp.asarray(T),
                                     with_bc)),
            rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", list(PHYSICS))
def test_diag_blocks_match_jax(case):
    Lj, Lt, jp, tp = _levels(case)
    for theta in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(
            tsemi.diag_blocks_A(Lt, tp, 0.3, theta).numpy(),
            np.asarray(jsemi.diag_blocks_A(Lj, jp, 0.3, theta)),
            rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_split", [0, 1, 3])
def test_flat_gather_matches_structured_gather(n_split):
    """One index gather == the JAX package's flat and structured gathers,
    at C = 1 (every face a macro face) and deeper splits."""
    Lj, Lt, _, _ = _levels("diffusion", n_split)
    X = _state(Lt, 1)
    got = tsemi.flat_gather(Lt, torch.tensor(X)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jsemi.flat_gather(Lj, jnp.asarray(X))))
    np.testing.assert_array_equal(
        got, np.asarray(jsemi.structured_gather(Lj, jnp.asarray(X))))

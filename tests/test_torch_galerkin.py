"""Galerkin coarse operator of the port (ops/galerkin.py) == the JAX
package's, float64 on the CPU.

- ``galerkin_coarse`` yields the JAX package's blocks bit for bit, on every
  coarse level of a chain, with surface terms on and off and with
  advection, down to n_split 5 (C = 1024 fine children per macro).
- It equals the geometric coarse assembly where the physics is scale
  invariant (no surface terms), and the dense triple product P^T A P with
  them (1e-10).
- A solver step with ``coarse_operator="galerkin"`` == JAX to 1e-11.
"""

import torch_threads  # noqa: F401

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.ops import galerkin as jgalerkin
from p_a_multigrids_tpu.ops import stencil as jstencil

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.models import semi as tsemi
from p_a_multigrids_tpu_torch.ops import galerkin as tgalerkin
from p_a_multigrids_tpu_torch.ops import stencil as tstencil

MESH = (3, 2, 1 / 3, 1 / 2)                 # U = 12
PHYSICS = {
    "sip": {},
    "advection": dict(advection=True, u=(0.3, 0.7)),
    "no_surface_advection": dict(advection=True, u=(0.3, 0.7),
                                 surface_terms=False),
}


def _port_datas(phys, n_split=2, levels=3, mesh=MESH):
    """The port's geometric stencils of every level, and its problem."""
    cfg = tcfg.SemiConfig(n_split=n_split, multi_levels=levels, dt=0.05,
                          dtype="float64", physics=tcfg.Physics(**phys))
    problem = tsemi.build_problem(tstruct.tri_mesh(*mesh), cfg)
    return [tstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
            for L in problem.levels], problem


@pytest.mark.parametrize("n_split,levels,mesh", [
    (2, 3, MESH), (5, 2, (2, 1, 0.5, 0.5))], ids=["n2", "n5"])
@pytest.mark.parametrize("phys", list(PHYSICS))
def test_galerkin_coarse_bit_identical_to_jax(phys, n_split, levels, mesh):
    """The chain datas[i] = P^T datas[i-1] P, as both solvers build it."""
    cfg = jcfg.SemiConfig(n_split=n_split, multi_levels=levels, dt=0.05,
                          dtype="float64",
                          physics=jcfg.Physics(**PHYSICS[phys]))
    problem = jsemi.build_problem(jstruct.tri_mesh(*mesh), cfg)
    geo = [jstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
           for L in problem.levels]
    want, got = geo[0], tstencil.StencilData(**vars(geo[0]))
    for i in range(1, levels):
        s = problem.levels[i]["s"]
        want = jgalerkin.galerkin_coarse(want, s, geo[i])
        got = tgalerkin.galerkin_coarse(
            got, s, tstencil.StencilData(**vars(geo[i])))
        for field in dataclasses.fields(got):
            a, b = getattr(got, field.name), getattr(want, field.name)
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=field.name)


def test_galerkin_equals_geometric_without_surface_terms():
    """Nested P1 spaces: P^T (M/dt + theta(D - K)) P == the rescaled coarse
    assembly when no surface terms are present."""
    datas, problem = _port_datas(PHYSICS["no_surface_advection"], levels=2)
    gal = tgalerkin.galerkin_coarse(datas[0], problem.levels[1]["s"],
                                    datas[1])
    for name in ("self_blocks", "face_blocks", "cross_blocks"):
        np.testing.assert_allclose(getattr(gal, name),
                                   getattr(datas[1], name), rtol=1e-12,
                                   atol=1e-13, err_msg=name)


def test_galerkin_matches_dense_triple_product():
    """Full SIP physics: the stencil P^T A P == the dense one."""
    datas, problem = _port_datas({}, levels=2)
    n_c = problem.levels[1]["s"]
    gal = tgalerkin.galerkin_coarse(datas[0], n_c, datas[1])
    U = problem.num_macro
    Cf, Cc = 4 ** (n_c + 1), 4 ** n_c
    _, parent, pw = tsemi._transfer_tables(n_c)
    P = np.zeros((U * Cf * 3, U * Cc * 3))
    for u in range(U):
        for fc in range(Cf):
            rows = (u * Cf + fc) * 3
            cols = (u * Cc + parent[fc]) * 3
            P[rows:rows + 3, cols:cols + 3] = pw[fc]
    want = P.T @ tstencil.to_dense(datas[0]) @ P
    np.testing.assert_allclose(tstencil.to_dense(gal), want, rtol=1e-10,
                               atol=1e-11)


@pytest.mark.parametrize("case", [
    dict(multi_levels=3),
    dict(multi_levels=3, cycle_type="w", advect=True),
    # the Galerkin coarsest continues into SA levels
    dict(multi_levels=2, coarse_direct_max_dof=0, agg_dense_max_dof=96),
], ids=["dense_coarse", "w_advection", "coarse_agg"])
def test_galerkin_step_matches_jax(case):
    case = dict(case)
    u = (0.4, -0.2) if case.pop("advect", False) else (0.0, 0.0)
    kw = dict(n_split=2, dt=0.05, dtype="float64", ntime=1,
              coarse_operator="galerkin", **case)
    js = jsemi.SemiSolver(jsemi.build_problem(
        jstruct.tri_mesh(*MESH), jcfg.SemiConfig(
            pallas_phase=False, physics=jcfg.Physics(
                advection=any(u), u=u), **kw)))
    ts = tsemi.SemiSolver(tsemi.build_problem(
        tstruct.tri_mesh(*MESH), tcfg.SemiConfig(
            physics=tcfg.Physics(advection=any(u), u=u), **kw)), "cpu")
    for jop, top in zip(js._stencil, ts.ops):
        np.testing.assert_array_equal(top._data.self_blocks,
                                      jop._data.self_blocks)
    assert (ts.agg is None) == (js._agg is None)
    T_t = np.random.default_rng(0).normal(size=(3, 16, 12))
    want = np.asarray(js._step_t(jnp.asarray(T_t)))
    got = ts._step_t(torch.tensor(T_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)

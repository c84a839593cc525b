"""The port's assembled paths (``ops.bsr``, ``models.semi_assembled``: modes
10 and 8) == the JAX package's, float64 on the CPU.

- The assembled operator: the same columns as the JAX package's
  ``assemble_operator`` and values to 1e-12, equal to the port's matrix-free
  ``apply_A`` to 1e-12 (the affine offset included), and on no-flux faces
  under advection equal to ``apply_A`` where the JAX package's is not (its
  diagonal blocks leave out the mirrored income flux; ROADMAP.md queue 3).
- Mode 10: a step == the JAX package's to 1e-11; one sweep == one
  block-Jacobi phase of the stencil (``phase_reference``).
- Mode 8: == the JAX package's ``direct_solve`` and == mode-9 PCG to 1e-8;
  the device densification == ``to_dense_numpy``.
- ``convert.assembled_from_numpy`` carries a JAX mode-10 solver over.
"""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.models import semi_assembled as jma

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch import convert
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.models import semi as tsemi
from p_a_multigrids_tpu_torch.models import semi_assembled as tma
from p_a_multigrids_tpu_torch.ops import bsr
from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t
from p_a_multigrids_tpu_torch.ops.phase import phase_reference

MESH = (4, 3, 0.25, 1 / 3)                   # U = 24
PHYSICS = {
    "diffusion": dict(diffusion=True, advection=False),
    "advection_diffusion": dict(diffusion=True, advection=True,
                                u=(0.7, -0.3)),
    "advection": dict(diffusion=False, advection=True, u=(1.0, 0.5)),
    "penalty_only": dict(diffusion=True, sip_consistency=False),
}


def _wall(x, y):
    return np.asarray(y) > 0.5


def _problems(phys=None, neumann=False, **kw):
    """(JAX problem, port problem) of one configuration, float64."""
    kw = dict(dict(n_split=2, multi_levels=1, dt=0.3, dtype="float64"), **kw)
    phys = phys or {}
    fj = jcfg.ProblemFns(neumann=_wall) if neumann else jcfg.ProblemFns()
    ft = tcfg.ProblemFns(neumann=_wall) if neumann else tcfg.ProblemFns()
    pj = jsemi.build_problem(jstruct.tri_mesh(*MESH), jcfg.SemiConfig(
        physics=jcfg.Physics(**phys), fns=fj, **kw))
    pt = tsemi.build_problem(tstruct.tri_mesh(*MESH), tcfg.SemiConfig(
        physics=tcfg.Physics(**phys), fns=ft, **kw))
    return pj, pt


def _state(pt, seed):
    U, C = pt.levels[0]["M"].shape[0], pt.levels[0]["C"]
    return np.random.default_rng(seed).normal(size=(U, C, 3))


@pytest.mark.parametrize("case", list(PHYSICS))
@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_assembled_operator_matches_jax(case, theta):
    pj, pt = _problems(PHYSICS[case])
    phys, dt = pt.cfg.physics, pt.cfg.dt
    want = jma.assemble_operator(pj.levels[0], pj.cfg.physics, dt, theta)
    got = tma.assemble_operator(pt.levels[0], phys, dt, theta)
    assert got.cols.dtype == np.int32 and got.cols.shape == (384, 4)
    np.testing.assert_array_equal(got.cols, np.asarray(want.cols))
    np.testing.assert_allclose(got.vals, np.asarray(want.vals), rtol=1e-12,
                               atol=1e-12)
    Lt = tsemi.level_tensors(pt.levels[0], "cpu")
    T = torch.tensor(_state(pt, 0))
    y = (got.rowop(torch.float64, "cpu")(T.reshape(-1, 3).T.contiguous())
         .T.reshape(T.shape))
    np.testing.assert_allclose(
        y.numpy(), tsemi.apply_A(Lt, phys, dt, theta, T, False).numpy(),
        rtol=1e-12, atol=1e-12)
    off = tma.affine_offset(pt.levels[0], phys, dt, theta)
    np.testing.assert_allclose(
        off, np.asarray(jma.affine_offset(pj.levels[0], pj.cfg.physics, dt,
                                          theta)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        y.numpy() + off, tsemi.apply_A(Lt, phys, dt, theta, T, True).numpy(),
        rtol=1e-12, atol=1e-12)


def test_assembled_operator_neumann_mirror():
    """No-flux faces under advection: the port's assembled operator equals
    the matrix-free one (and its block stencil); the JAX package's leaves
    out the mirrored income flux and does not."""
    pj, pt = _problems(dict(diffusion=True, advection=True, u=(1.0, 0.0)),
                       neumann=True)
    phys, dt = pt.cfg.physics, pt.cfg.dt
    T = torch.tensor(_state(pt, 1))
    s = tma.AssembledSemiSolver(pt, "cpu")
    Lt = tsemi.level_tensors(pt.levels[0], "cpu")
    mf = tsemi.apply_A(Lt, phys, dt, 1.0, T, True)
    np.testing.assert_allclose(s.apply_assembled(T).numpy(), mf.numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        from_t(s.ops[0].apply(to_t(T), True)).numpy(), mf.numpy(),
        rtol=1e-12, atol=1e-12)
    A_j = jma.assemble_operator(pj.levels[0], pj.cfg.physics, dt, 1.0)
    y_j = np.asarray(A_j.spmv(jnp.asarray(T.numpy().reshape(-1, 3))))
    y_j = y_j.reshape(T.shape) + s.offset.numpy()
    assert np.abs(y_j - mf.numpy()).max() > 1e-3


def _mode10_pair(**kw):
    pj, pt = _problems(**kw)
    return jma.AssembledSemiSolver(pj), tma.AssembledSemiSolver(pt, "cpu")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(phys=dict(diffusion=True, advection=True, u=(0.7, -0.3)),
         theta=0.5),
    dict(n_multigrid=3, n_smooth=2, omega=0.7),
], ids=["defaults", "advection_cn", "sweeps_omega"])
def test_mode10_step_matches_jax(kw):
    js, ts = _mode10_pair(**kw)
    T = _state(ts.p, 2)
    got = ts._step(torch.tensor(T)).numpy()
    np.testing.assert_allclose(got, np.asarray(js._step(jnp.asarray(T))),
                               rtol=1e-11, atol=1e-11)
    assert float(ts.convergence(torch.tensor(got))) == pytest.approx(
        float(js.convergence(jnp.asarray(got))), rel=1e-9)


def test_mode10_run_matches_jax():
    js, ts = _mode10_pair(ntime=2)
    np.testing.assert_allclose(ts.run().numpy(), np.asarray(js.run()),
                               rtol=1e-11, atol=1e-11)


def test_mode10_sweep_equals_stencil_jacobi():
    """One assembled sweep == one block-Jacobi round of the stencil phase
    (``phase_reference``): the same fixed point, through the BSR SpMV."""
    _, pt = _problems(n_multigrid=1, n_smooth=1, ntime=1)
    s = tma.AssembledSemiSolver(pt, "cpu")
    T = torch.tensor(_state(pt, 3))
    op = s.ops[0]
    x_t, _ = phase_reference(op, to_t(T), op._bp(s._rhs_t(to_t(T)), True),
                             [s.cfg.omega], want_z=False)
    np.testing.assert_allclose(s._step(T).numpy(), from_t(x_t).numpy(),
                               rtol=1e-11, atol=1e-11)


def test_to_dense_matches_numpy():
    _, pt = _problems(PHYSICS["advection_diffusion"])
    A = tma.assemble_operator(pt.levels[0], pt.cfg.physics, 0.3, 1.0)
    np.testing.assert_array_equal(
        bsr.to_dense(A.rowop(torch.float64, "cpu")).numpy(),
        bsr.to_dense_numpy(A))


def test_mode8_matches_jax_and_pcg():
    kw = dict(n_split=1, multi_levels=1, dt=0.5, ntime=2, n_multigrid=1,
              krylov=True, krylov_tol=1e-12, dtype="float64")
    _, Tj = jma.direct_solve(jstruct.tri_mesh(*MESH),
                             jcfg.SemiConfig(**kw))
    s8, T8 = tma.direct_solve(tstruct.tri_mesh(*MESH), tcfg.SemiConfig(**kw),
                              "cpu")
    assert s8.inverse_seconds > 0
    np.testing.assert_allclose(T8.numpy(), np.asarray(Tj), rtol=1e-10,
                               atol=1e-10)
    s9 = tsemi.SemiSolver(tsemi.build_problem(tstruct.tri_mesh(*MESH),
                                              tcfg.SemiConfig(**kw)), "cpu")
    assert np.abs(T8.numpy() - s9.run().numpy()).max() < 1e-8


def test_assembled_from_numpy_round_trip():
    js, ts = _mode10_pair(ntime=2)
    conv = convert.assembled_from_numpy(
        ts.cfg, js.p.levels, np.asarray(js.A_bsr.cols),
        np.asarray(js.A_bsr.vals), np.asarray(js.offset),
        js._stencil[0]._data, np.asarray(js.p.analytical), "cpu",
        grid=js.p.grid, coords_fine=js.p.coords_fine)
    assert torch.equal(conv.A.cols_t, ts.A.cols_t)
    T0 = _state(ts.p, 4)
    got = conv.run(torch.tensor(T0)).numpy()
    np.testing.assert_allclose(got, ts.run(torch.tensor(T0)).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(js.run(jnp.asarray(T0))),
                               rtol=1e-11, atol=1e-11)

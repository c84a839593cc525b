"""One solver step of the port == the JAX package's, float64 on the CPU.

The JAX side runs its XLA stencil path (pallas_phase=False), or for the
point smoothers and the non-stencil path its standard-layout cycle; the
port runs its phase formulation (phase_reference on CPU tensors), the
smoothers over the zero-round apply, or the fused operator, and its SA
levels through rowop_reference.  Steps agree to 1e-11 (theta-schemes,
BiCGStab, the solver menu and the non-stencil path included); PCG takes the
same number of iterations and reaches the same solution to 1e-9.  The
probed stencil equals the closed form blockwise.
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
from p_a_multigrids_tpu.ops import krylov as jkrylov
from p_a_multigrids_tpu.ops import stencil as jstencil

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch import convert
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.models import semi as tsemi
from p_a_multigrids_tpu_torch.ops import stencil as tstencil
from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t

MESH = (4, 4, 0.25, 0.25)                   # U = 32
FORCED_COARSE = dict(coarse_direct_max_dof=0, coarse_agg=False,
                     coarse_cheb_degree=8)
CASES = {
    "dense_coarse": dict(n_split=2, multi_levels=2),
    "forced_coarse_phase": dict(n_split=2, multi_levels=2, **FORCED_COARSE),
    "coarse_pack4": dict(n_split=2, multi_levels=2, coarse_pack=4,
                         **FORCED_COARSE),
    "w_cycle": dict(n_split=2, multi_levels=3, cycle_type="w"),
    "block_jacobi_corner_avg": dict(n_split=2, multi_levels=2,
                                    solver="block_jacobi",
                                    restrictor="corner_average"),
    "advection": dict(n_split=2, multi_levels=2, advect=True),
    # SA correction of the finest level: factored fine transfers, several
    # SA levels and a dense bottom
    "amg": dict(n_split=2, multi_levels=1, amg=True, agg_strength=0.5,
                agg_dense_max_dof=128),
    # stored smoothed transfers (advection: the factorization needs a
    # symmetric operator); the geometric level below is bypassed
    "amg_advection": dict(n_split=2, multi_levels=2, amg=True, advect=True,
                          agg_dense_max_dof=128),
    "amg_two_cycles": dict(n_split=2, multi_levels=1, amg=True,
                           agg_cycles=2, agg_sweeps=1),
    # coarse_agg: SA continues below a geometric coarsest that the dense
    # inverse does not take
    "coarse_agg": dict(n_split=2, multi_levels=2, coarse_direct_max_dof=0,
                       agg_dense_max_dof=96),
    # theta-schemes: Crank-Nicolson's explicit half through apply_spatial
    "theta_half": dict(n_split=2, multi_levels=2, theta=0.5),
    "theta_half_advection": dict(n_split=2, multi_levels=2, theta=0.5,
                                 advect=True),
    # explicit (mode 7): A = M/dt, one exact block-Jacobi round
    "theta_zero": dict(n_split=2, multi_levels=1, theta=0.0, n_multigrid=1,
                       n_smooth=1, omega=1.0, solver="block_jacobi"),
    # BiCGStab: krylov under advection, V-cycle preconditioned
    "bicgstab": dict(n_split=2, multi_levels=2, advect=True, krylov=True),
    "bicgstab_theta_half": dict(n_split=2, multi_levels=2, advect=True,
                                krylov=True, theta=0.5),
    # the solver menu on the stencil path, with the omegas of the JAX
    # package's tests/test_semi.py (point relaxation of the SIP operator
    # needs a smaller omega than block relaxation)
    "jacobi": dict(n_split=2, multi_levels=2, solver="jacobi", omega=0.5),
    "richardson": dict(n_split=2, multi_levels=2, solver="richardson",
                       omega=0.01),
    "gauss_seidel": dict(n_split=2, multi_levels=2, solver="gauss_seidel",
                         omega=0.5),
    # without surface terms no element couples to another: GS is Jacobi
    "gauss_seidel_no_surface": dict(n_split=2, multi_levels=2,
                                    solver="gauss_seidel", surface=False),
    # direct relaxes as Jacobi
    "direct": dict(n_split=2, multi_levels=2, solver="direct", omega=0.5),
    # the reference's active mode-9 configuration (tests/test_semi.py)
    "reference_mode9": dict(n_split=2, multi_levels=2, dt=1.25e-5,
                            n_multigrid=6, solver="jacobi",
                            restrictor="corner_average", surface=False),
    # the non-stencil path: the fused operator (or apply_A) with exact
    # block inverses; the dense coarse inverse from apply_A's columns
    "non_stencil_chebyshev": dict(n_split=2, multi_levels=1,
                                  stencil_operator=False, cheb_degree=3),
    "non_stencil_block_jacobi": dict(n_split=2, multi_levels=2,
                                     stencil_operator=False,
                                     solver="block_jacobi"),
    "no_fast_operator": dict(n_split=1, multi_levels=2,
                             stencil_operator=False, fast_operator=False,
                             advect=True),
    # the stencil probed from apply_A instead of the closed form
    "stencil_probe": dict(n_split=2, multi_levels=2, stencil_probe=True),
}


def _pair(dt=0.05, advect=False, solver=None, surface=True, **kw):
    """(JAX solver, port solver) on the same mesh and configuration."""
    u = (0.4, -0.2) if advect else (0.0, 0.0)
    kw = dict(dict(dt=dt, dtype="float64", ntime=1), **kw)
    jc = jcfg.SemiConfig(pallas_phase=False, physics=jcfg.Physics(
        advection=advect, u=u, surface_terms=surface), **kw)
    tc = tcfg.SemiConfig(physics=tcfg.Physics(
        advection=advect, u=u, surface_terms=surface), **kw)
    if solver:
        jc = dataclasses.replace(jc, solver=jcfg.Solver(solver))
        tc = dataclasses.replace(tc, solver=tcfg.Solver(solver))
    js = jsemi.SemiSolver(jsemi.build_problem(jstruct.tri_mesh(*MESH), jc))
    ts = tsemi.SemiSolver(tsemi.build_problem(tstruct.tri_mesh(*MESH), tc),
                          "cpu")
    return js, ts


def _state(js, seed=0):
    U = js.p.num_macro
    C = js.p.levels[0]["C"]
    return np.random.default_rng(seed).normal(size=(3, C, U))


def _jax_step_t(js, T_t):
    """The JAX solver's step of a transposed state: its transposed step
    where it runs the transposed cycle, else its standard-layout step."""
    if js._use_t_cycle:
        return np.asarray(js._step_t(jnp.asarray(T_t)))
    return np.asarray(js._step(jnp.asarray(T_t.transpose(2, 1, 0)))
                      ).transpose(2, 1, 0)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(case):
    js, ts = _pair(**CASES[case])
    T_t = _state(js)
    want = _jax_step_t(js, T_t)
    got = ts._step_t(torch.tensor(T_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)
    assert ts.stencil == (js._stencil is not None)
    assert ts.phase_cycle == js._use_t_cycle
    if case == "coarse_pack4":
        assert js._pack == [1, 4]           # JAX packed; the port need not
    assert (ts.agg is None) == (js._agg is None)
    assert ts._agg_li == js._agg_li
    if "agg" in case:
        assert ts.agg is not None
        assert len(ts.agg.levels) == len(js._agg.levels)
        assert (ts.agg.tent_r is None) == (js._agg.fine is None)


def _pcg_matches_jax(js, ts, T_t):
    b_j = js._rhs_t(jnp.asarray(T_t))
    op = js._stencil[0]
    b_lin = b_j - op.apply(jnp.zeros_like(b_j), True)
    x_j, it_j, _ = jkrylov.pcg(
        lambda v: js._apply_t(0, v, False), b_lin, jnp.asarray(T_t),
        precond=lambda r: js._vcycle_t(0, jnp.zeros_like(r), r, hom=True),
        tol=1e-8, maxiter=200)
    x_t = ts._step_t(torch.tensor(T_t))
    assert ts.krylov_iters == [int(it_j)]
    assert 2 < int(it_j) < 200
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-9,
                               atol=1e-9)


def test_pcg_matches_jax():
    """Same iteration count, same solution (1e-9), same stopping rule."""
    js, ts = _pair(krylov=True, krylov_tol=1e-8)
    _pcg_matches_jax(js, ts, _state(js, 1))


def test_amg_pcg_matches_jax():
    """SA-preconditioned PCG (the production implicit solve) takes the JAX
    package's iteration count to the same solution."""
    js, ts = _pair(n_split=2, multi_levels=1, amg=True, agg_strength=0.5,
                   agg_dense_max_dof=128, krylov=True, krylov_tol=1e-8)
    assert ts.agg is not None
    _pcg_matches_jax(js, ts, _state(js, 4))


def test_factored_transfers_match_stored():
    """The factored fine transfers (P_tent + one K1 apply per side) == the
    stored smoothed-transfer tables: P = (I - w D^-1 A) P_tent exactly."""
    js, ts = _pair(n_split=2, multi_levels=1, amg=True, agg_strength=0.4)
    r_t = torch.tensor(_state(js, 7))
    x0 = torch.zeros_like(r_t)
    e_fact = ts._agg_correct_t(0, x0, r_t)
    tent_r, ts.agg.tent_r = ts.agg.tent_r, None
    try:
        e_stored = ts._agg_correct_t(0, x0, r_t)
    finally:
        ts.agg.tent_r = tent_r
    np.testing.assert_allclose(e_fact.numpy(), e_stored.numpy(), rtol=1e-9,
                               atol=1e-10)


def test_coarse_krylov_step_matches_jax():
    js, ts = _pair(n_split=2, multi_levels=2, coarse_krylov=True,
                   coarse_agg=False, coarse_direct_max_dof=0,
                   coarse_sweeps=6)
    T_t = _state(js, 2)
    want = np.asarray(js._step_t(jnp.asarray(T_t)))
    got = ts._step_t(torch.tensor(T_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)


def test_run_error_convergence_match_jax():
    js, ts = _pair(n_split=2, multi_levels=2, dt=1e8, ntime=2,
                   n_multigrid=4)
    Tj = js.run()
    Tt = ts.run()
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-11,
                               atol=1e-11)
    np.testing.assert_allclose(ts.error(Tt).numpy(),
                               np.asarray(js.error(Tj)), atol=1e-11)
    assert float(ts.convergence(Tt)) == pytest.approx(
        float(js.convergence(Tj)), rel=1e-6, abs=1e-12)
    assert float(ts.error(Tt).mean()) < 0.01
    r = ts.residual(0, Tt, from_t(ts._rhs_t(to_t(Tt))), True)
    assert float(r.abs().max()) == pytest.approx(float(ts.convergence(Tt)))


def test_solver_from_numpy_equals_own_setup():
    """The port's solver built from the JAX solver's host arrays runs the
    same step as the port's own setup (and as JAX)."""
    js, ts = _pair(n_split=2, multi_levels=2, krylov=False)
    conv = convert.solver_from_numpy(
        ts.cfg, js.p.levels, [op._data for op in js._stencil], js._lam_max,
        js._coarse_inv_np, np.asarray(js.p.analytical), "cpu",
        grid=js.p.grid, coords_fine=js.p.coords_fine)
    T0 = np.asarray(js.initial_condition()) + _state(js, 3).transpose(2, 1, 0)
    got = convert.state_to_numpy(conv.run(convert.state_from_numpy(conv, T0)))
    own = convert.state_to_numpy(ts.run(convert.state_from_numpy(ts, T0)))
    np.testing.assert_array_equal(got, own)
    np.testing.assert_allclose(got, np.asarray(js.run(jnp.asarray(T0))),
                               rtol=1e-11, atol=1e-11)
    assert torch.equal(conv.initial_condition(), ts.initial_condition())


@pytest.mark.parametrize("case", ["amg", "coarse_agg"])
def test_solver_from_numpy_carries_agg(case):
    """The port's solver built from the JAX solver's host arrays, SA
    hierarchy included, runs the port's own step (and JAX's)."""
    js, ts = _pair(**CASES[case])
    conv = convert.solver_from_numpy(
        ts.cfg, js.p.levels, [op._data for op in js._stencil], js._lam_max,
        js._coarse_inv_np, np.asarray(js.p.analytical), "cpu",
        grid=js.p.grid, coords_fine=js.p.coords_fine, agg=js._agg)
    assert conv._agg_li == js._agg_li
    T_t = _state(js, 5)
    got = conv._step_t(torch.tensor(T_t)).numpy()
    np.testing.assert_array_equal(got, ts._step_t(torch.tensor(T_t)).numpy())
    np.testing.assert_allclose(
        got, np.asarray(js._step_t(jnp.asarray(T_t))), rtol=1e-11,
        atol=1e-11)


def test_direct_relaxes_as_jacobi():
    """--solver direct falls through to Jacobi: the same step bit for
    bit."""
    _, tj = _pair(n_split=2, multi_levels=2, solver="jacobi", omega=0.5)
    _, td = _pair(n_split=2, multi_levels=2, solver="direct", omega=0.5)
    T_t = torch.tensor(_state(tj))
    assert torch.equal(tj._step_t(T_t), td._step_t(T_t))


def test_jacobi_amg_pcg_matches_jax():
    """Point Jacobi under the SA correction (stored transfers, as the JAX
    package's standard-layout cycle runs them) preconditioning PCG."""
    js, ts = _pair(n_split=2, multi_levels=1, amg=True, agg_strength=0.5,
                   agg_dense_max_dof=128, solver="jacobi", omega=0.5,
                   krylov=True, krylov_tol=1e-8)
    assert ts.agg is not None and js._agg is not None
    T_t = _state(js, 6)
    want = _jax_step_t(js, T_t)
    got = ts._step_t(torch.tensor(T_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["non_stencil_chebyshev",
                                  "non_stencil_block_jacobi"])
def test_non_stencil_solver_from_numpy(case):
    """The port's non-stencil solver built from the JAX solver's host
    arrays (_lam_max, _block_inv, the dense coarse inverse) runs the same
    step as the port's own setup and as JAX."""
    js, ts = _pair(**CASES[case])
    conv = convert.solver_from_numpy(
        ts.cfg, js.p.levels, None, getattr(js, "_lam_max", None),
        None if js._coarse_inv is None else np.asarray(js._coarse_inv),
        np.asarray(js.p.analytical), "cpu",
        grid=js.p.grid, coords_fine=js.p.coords_fine,
        block_inv=[np.asarray(B) for B in js._block_inv])
    T_t = _state(js, 8)
    got = conv._step_t(torch.tensor(T_t)).numpy()
    np.testing.assert_allclose(got, ts._step_t(torch.tensor(T_t)).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, _jax_step_t(js, T_t), rtol=1e-11,
                               atol=1e-11)


PROBE_PHYSICS = {
    "diffusion": dict(),
    "advect_diffuse": dict(advection=True, u=(0.7, -0.3)),
    "no_surface": dict(surface_terms=False),
    "penalty_only": dict(sip_consistency=False),
}


@pytest.mark.parametrize("phys", list(PROBE_PHYSICS))
def test_probe_stencil_equals_closed_form(phys):
    """probe_stencil (the port's apply_A probed) == build_stencil blockwise
    and == the JAX package's probe, as tests/test_stencil.py holds the JAX
    closed form to its probe (a no-flux top wall under advection)."""
    kw = dict(n_split=2, multi_levels=1, dt=0.05, dtype="float64")
    jfns, tfns = jcfg.ProblemFns(), tcfg.ProblemFns()
    if phys == "advect_diffuse":
        jfns.neumann = tfns.neumann = lambda x, y: y > 0.8
    jc = jcfg.SemiConfig(physics=jcfg.Physics(**PROBE_PHYSICS[phys]),
                         fns=jfns, **kw)
    tc = tcfg.SemiConfig(physics=tcfg.Physics(**PROBE_PHYSICS[phys]),
                         fns=tfns, **kw)
    jL = jsemi.build_problem(jstruct.tri_mesh(*MESH), jc).levels[0]
    tL = tsemi.build_problem(tstruct.tri_mesh(*MESH), tc).levels[0]
    probed = tstencil.probe_stencil(tL, tc.physics, tc.dt, tc.theta)
    exact = tstencil.build_stencil(tL, tc.physics, tc.dt, tc.theta)
    jprobed = jstencil.probe_stencil(jL, jc.physics, jc.dt, jc.theta)
    for field in ("self_blocks", "face_blocks", "cross_blocks", "c_aff"):
        for want in (exact, jprobed):
            np.testing.assert_allclose(
                getattr(probed, field), getattr(want, field), rtol=1e-11,
                atol=1e-12, err_msg=field)
    for field in ("halo_src", "bnd_c", "bnd_f", "intra_onehot",
                  "cross_onehot"):
        np.testing.assert_array_equal(getattr(probed, field),
                                      getattr(exact, field))

"""The plain reference against the port on the CPU at tiny sizes: the
assembled operator, the Dirichlet data and the source equal the port's
matrix-free ones in float64; the reference cycles follow the port's step
to round-off; the comparisons accept the port's float32 output, reject a
perturbed state, and their TF32 controls come out as not correct.

    python -m pytest -q pamg_bench/tests
"""

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu_torch.config import SemiConfig
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t
from pamg_bench.reference import check, dg, multigrid

MESHES = [((3, 2, 1 / 3, 1 / 2), 2, 2), ((4, 3, 3 / 4, 1 / 3), 1, 2),
          ((2, 2, 0.5, 0.5), 3, 3)]
GEO = dict(n_split=2, multi_levels=2, dt=0.05, coarse_agg=False,
           coarse_cheb_degree=8, coarse_cheb_lower=0.02,
           coarse_direct_max_dof=0)
W = dict(n_split=3, multi_levels=3, dt=1e8, cycle_type="w",
         coarse_direct_max_dof=0, coarse_agg=False)
AMG = dict(n_split=2, multi_levels=1, dt=0.05, amg=True, agg_strength=0.5,
           cheb_degree=16, cheb_lower=0.05, krylov=True, krylov_tol=1e-6)


def _solver(params, fields, dtype):
    cfg = SemiConfig(dtype=dtype, **fields)
    return semi.SemiSolver(semi.build_problem(structured.tri_mesh(*params),
                                              cfg), "cpu")


def _step(solver, T, dtype):
    x = solver._step_t(to_t(torch.tensor(T, dtype=getattr(torch, dtype))))
    return from_t(x).double().numpy().reshape(-1)


@pytest.mark.parametrize("params,n_split,levels", MESHES)
def test_macro_mesh_and_operator_equal_the_port(params, n_split, levels):
    mesh = structured.tri_mesh(*params)
    X = dg.structured_macro_X(*params)
    assert np.array_equal(X, mesh.X)
    cfg = SemiConfig(n_split=n_split, multi_levels=levels, dt=0.05,
                     dtype="float64")
    prob = semi.build_problem(mesh, cfg)
    rng = np.random.default_rng(1)
    for li, L in enumerate(prob.levels):
        lvl = dg.assemble(X, L["s"], li, 0.05, 1.0)
        Lt = semi.level_tensors(L, "cpu")
        T = rng.normal(size=(lvl.U, lvl.C, 3))
        for with_bc in (False, True) if li == 0 else (False,):
            got = semi.apply_A(Lt, cfg.physics, 0.05, 1.0, torch.tensor(T),
                               with_bc).numpy().reshape(-1)
            mine = lvl.A @ T.reshape(-1) + (lvl.c if with_bc else 0.0)
            assert np.abs(got - mine).max() <= 1e-13 * np.abs(got).max()
    assert np.abs(prob.levels[0]["source"].reshape(-1)
                  - dg.assemble(X, n_split, 0, 0.05, 1.0).s).max() < 1e-14


@pytest.mark.parametrize("params,fields", [((6, 3, 0.5, 1 / 6), GEO),
                                           ((4, 3, 0.25, 0.25), W)])
def test_reference_cycles_follow_the_port(params, fields):
    X = dg.structured_macro_X(*params)
    chk = check.CycleCheck(X, fields)
    lvl = chk.cycle.levels[0]
    T = np.random.default_rng(3).normal(size=(lvl.U, lvl.C, 3))
    solver = _solver(params, fields, "float64")
    assert np.allclose(chk.cycle.lam, solver._lam_max, rtol=1e-12)
    assert chk.number(T.reshape(-1), _step(solver, T, "float64")) < 1e-12
    f32 = chk.number(T.reshape(-1), _step(_solver(params, fields,
                                                  "float32"), T, "float32"))
    low = chk.number(T.reshape(-1), chk.control(T.reshape(-1)))
    assert f32 < 1e-5 and low > 30 * f32
    x = _step(solver, T, "float64")
    x[7] += 1e-2 * np.abs(x).max()
    assert chk.number(T.reshape(-1), x) > 1e-6


@pytest.mark.parametrize("params,fields", [((8, 4, 3 / 8, 1 / 8), AMG),
                                           ((4, 3, 0.25, 0.25),
                                            {**W, "krylov": True,
                                             "krylov_tol": 1e-6,
                                             "multi_levels": 4})])
def test_solve_check_accepts_the_port_and_rejects_faults(params, fields):
    X = dg.structured_macro_X(*params)
    chk = check.SolveCheck(X, fields)
    T = np.random.default_rng(4).normal(size=(chk.level.U, chk.level.C, 3))
    T = T.reshape(-1)
    f64 = chk.number(T, _step(_solver(params, fields, "float64"),
                              T.reshape(chk.level.U, -1, 3), "float64"))
    f32 = chk.number(T, _step(_solver(params, fields, "float32"),
                              T.reshape(chk.level.U, -1, 3), "float32"))
    assert f64 <= 1e-6 and f32 < 1e-5
    assert chk.number(T, chk.control(T)) > 100 * f32
    assert chk.number(T, T) > 1e-2
    assert check.worst(chk, [(T, T * np.nan)]) == float("inf")


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0e-5, -2.5])
    assert multigrid.tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -10,
                                          multigrid.tf32(3.0e-5)[()], -2.5]
    r = np.random.default_rng(0).normal(size=1000)
    rel = np.abs(multigrid.tf32(r) - r) / np.abs(r)
    assert rel.max() <= 2 ** -11 * (1 + 1e-6) and rel.max() > 2 ** -13

"""The port's sanitizer (utils/debugging, SemiConfig.debug, --debug) on the
CPU: a clean checked run gives exactly the unchecked run's numbers
(float64, atol 0), a NaN initial condition raises FloatingPointError as it
does in the JAX package (tests/test_debugging.py), a non-finite value out
of a plain K1 or K2 call raises at its call site, every index table is
range-checked when the solver is built, the error record decodes into
IndexError / FloatingPointError, and the --debug CLI equals the JAX
package's at rel 1e-9."""

import torch_threads  # noqa: F401

import dataclasses
import json

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import __main__ as jcli

from p_a_multigrids_tpu_torch import __main__ as tcli
from p_a_multigrids_tpu_torch.config import ProblemFns, SemiConfig, Solver
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi, semi_assembled
from p_a_multigrids_tpu_torch.utils import debugging
from p_a_multigrids_tpu_torch.utils.expressions import Expression


def _mesh():
    return structured.tri_mesh(3, 3, 1.0 / 3, 1.0 / 3)


# tests/test_debugging.py's clean configuration, and the other paths a
# checked step takes: the K1 phase cycle with SA levels (K2), the point
# smoothers over K1's apply, the non-stencil operator, the theta-scheme's
# explicit part, and PCG
CLEAN = {
    "reference": dict(n_split=1, multi_levels=1, ntime=1, dt=1e3,
                      n_multigrid=2),
    "amg": dict(n_split=2, multi_levels=1, ntime=2, dt=0.05,
                n_multigrid=2, amg=True),
    "coarse_agg": dict(n_split=2, multi_levels=2, ntime=1, dt=0.05,
                       coarse_direct_max_dof=100),
    "jacobi": dict(n_split=2, multi_levels=2, ntime=2, dt=0.05,
                   solver=Solver.JACOBI),
    "fused": dict(n_split=2, multi_levels=2, ntime=2, dt=0.05,
                  stencil_operator=False),
    "theta_krylov": dict(n_split=2, multi_levels=2, ntime=2, dt=0.05,
                         theta=0.5, krylov=True),
}


@pytest.mark.parametrize("name", sorted(CLEAN))
def test_debug_clean_run_is_identical(name):
    cfg = SemiConfig(dtype="float64", **CLEAN[name])
    mesh = _mesh()
    _, T_ref = semi.solve(mesh, cfg, "cpu")
    solver, T_dbg = semi.solve(mesh, dataclasses.replace(cfg, debug=True),
                               "cpu")
    assert solver.sanitizer is not None
    np.testing.assert_allclose(T_dbg.numpy(), T_ref.numpy(), rtol=0, atol=0)
    assert np.isfinite(T_dbg.numpy()).all()


def test_debug_mode10_clean_run_is_identical():
    cfg = SemiConfig(n_split=1, multi_levels=1, ntime=2, dt=0.05,
                     dtype="float64")
    problem = semi.build_problem(_mesh(), cfg)
    plain = semi_assembled.AssembledSemiSolver(problem, "cpu")
    dbg = semi_assembled.AssembledSemiSolver(
        dataclasses.replace(problem, cfg=dataclasses.replace(cfg,
                                                             debug=True)),
        "cpu")
    assert dbg.A.sanitizer is not None and plain.A.sanitizer is None
    np.testing.assert_array_equal(dbg.run().numpy(), plain.run().numpy())


@pytest.mark.parametrize("ic", [
    lambda x, y: np.where(x > 10.0, 0.0, np.nan) + 0 * x,
    Expression("sqrt(-1 - x)"),
], ids=["callable", "expression"])
def test_debug_mode_catches_nan_initial_condition(ic):
    cfg = SemiConfig(n_split=1, multi_levels=1, ntime=1, dt=1e3,
                     n_multigrid=1, dtype="float64", debug=True,
                     fns=ProblemFns(ic=ic), manufactured=False)
    solver = semi.SemiSolver(semi.build_problem(_mesh(), cfg), "cpu")
    with pytest.raises(FloatingPointError, match="state before the step"):
        with np.errstate(invalid="ignore"):
            solver.run()


@pytest.mark.parametrize("amg", [False, True], ids=["k1", "k2"])
def test_call_site_check_catches_nonfinite_output(amg):
    """An infinite coefficient makes the first kernel call's output
    non-finite: the CPU's check after the plain version raises there."""
    cfg = SemiConfig(n_split=1, multi_levels=1, ntime=1, dt=1e3,
                     dtype="float64", debug=True, amg=amg)
    solver = semi.SemiSolver(semi.build_problem(_mesh(), cfg), "cpu")
    if amg:
        solver.agg.levels[0].op.vals_t[0, 0, 0, 0] = np.inf
        call = lambda: solver.agg.levels[0].op(
            torch.ones(3, solver.agg.levels[0].n, dtype=torch.float64))
        match = "K2"
    else:
        solver.ops[0].Fp_t[0, 0, 0, 0, 0] = np.inf
        call = solver.run
        match = "K1"
    with pytest.raises(FloatingPointError, match=match):
        call()


def _solvers():
    mesh = _mesh()
    out = {}
    for name, kw in CLEAN.items():
        cfg = SemiConfig(dtype="float64", **kw)
        out[name] = semi.SemiSolver(semi.build_problem(mesh, cfg), "cpu")
    cfg = SemiConfig(n_split=1, multi_levels=1, dt=0.05, dtype="float64")
    out["mode10"] = semi_assembled.AssembledSemiSolver(
        semi.build_problem(mesh, cfg), "cpu")
    return out


def test_every_index_table_has_a_range():
    """check_index_tables knows a range for every integer buffer of every
    solver kind (else TypeError), and checks some on each."""
    counts = {k: debugging.check_index_tables(sv)
              for k, sv in _solvers().items()}
    assert all(n > 0 for n in counts.values()), counts
    assert counts["amg"] > counts["reference"]


@pytest.mark.parametrize("table", ["src_cu", "intra_rows", "slot_idx",
                                   "cols_t", "parent_1", "fused"])
def test_index_table_out_of_range_raises_at_build(table):
    """One index set out of range (a negative one, which torch's indexing
    would wrap silently) raises IndexError naming the table."""
    sv = _solvers()
    if table == "cols_t":
        solver = sv["amg"]
        solver.agg.levels[0].op.cols_t[0, 0] = -1
        name = "agg.levels.0.op.cols_t"
    elif table == "parent_1":
        solver = sv["jacobi"]
        solver.parent_1[3] = solver.p.levels[1]["C"]
        name = "parent_1"
    elif table == "fused":
        solver = sv["fused"]
        solver.fused[0].halo_idx[0, 0] = -2
        name = "fused.0.halo_idx"
    else:
        solver = sv["reference"]
        getattr(solver.ops[0], table).view(-1)[0] = -1
        name = f"ops.0.{table}"
    with pytest.raises(IndexError, match=name.replace(".", r"\.")):
        debugging.check_index_tables(solver)
    with pytest.raises(IndexError):
        debugging.attach(solver)


def test_unknown_index_table_raises():
    solver = _solvers()["reference"]
    solver.register_buffer("mystery", torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError, match="mystery"):
        debugging.check_index_tables(solver)


def test_error_record_decodes():
    """The record a checked kernel writes raises the right error, naming
    the kernel, the operator's level and the position, and is zeroed."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05, amg=True,
                     dtype="float64", debug=True)
    solver = semi.SemiSolver(semi.build_problem(_mesh(), cfg), "cpu")
    san = solver.sanitizer
    site = solver.ops[0].sanitizer
    U = solver.ops[0].U
    san.record[:8] = torch.tensor([1, 1, 1, site.index, 5 * U + 2, 8, 999,
                                   16 * U], dtype=torch.int32)
    with pytest.raises(IndexError, match=r"K1 .*level 0 .*src \(slot 0\) of "
                       rf"pair {5 * U + 2} \(child 5, macro 2\) holds 999"):
        san.raise_on_fault()
    assert int(san.record.abs().sum()) == 0
    san.raise_on_fault()
    k2 = solver.agg.levels[0].op.sanitizer
    bits = int(np.float32(np.inf).view(np.int32))
    san.record[:8] = torch.tensor([1, 2, 2, k2.index, 17, 1, bits, 0],
                                  dtype=torch.int32)
    with pytest.raises(FloatingPointError,
                       match=r"K2 .*agg\.levels\.0\.op.*inf as y dof 1 of "
                       r"row 17"):
        san.raise_on_fault()
    assert san.sites[k2.index] is k2


def test_assert_finite_helper():
    debugging.assert_finite(np.ones(4), "ok")
    debugging.assert_finite(torch.ones(4), "ok")
    with pytest.raises(FloatingPointError, match="2/4"):
        debugging.assert_finite(np.array([1.0, np.nan, np.inf, 0.0]), "bad")


def test_checked_wrapper_reads_record_after_step():
    san = debugging.Sanitizer("cpu")
    calls = []

    def step(T):
        calls.append(1)
        san.record[0] = 1
        san.record[1] = 2
        san.record[2] = 1
        san.record[4] = 3
        san.record[6] = -4
        san.record[7] = 10
        return T

    san.site("op")
    wrapped = debugging.checked(step, san)
    with pytest.raises(IndexError, match="holds -4, outside"):
        wrapped(torch.zeros(2))
    assert calls == [1]
    with pytest.raises(FloatingPointError):
        wrapped(torch.tensor([np.nan]))
    assert calls == [1]


def test_cli_debug_matches_jax(capsys):
    argv = ["--mode", "9", "--rows", "3", "--cols", "3", "--n-split", "1",
            "--levels", "1", "--ntime", "2", "--debug"]
    jcli.main(argv + ["--cpu", "--f64"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tcli.main(argv + ["--device", "cpu", "--f64"])
    capsys.readouterr()
    for key in ("L1_error", "residual", "residual_history"):
        assert got[key] == pytest.approx(want[key], rel=1e-9), key


@pytest.mark.parametrize("argv", [
    ["--mode", "9", "--levels", "1", "--amg", "--krylov"],
    ["--mode", "9", "--levels", "2", "--solver", "gauss_seidel"],
    ["--mode", "7"], ["--mode", "10"],
], ids=["amg_krylov", "gauss_seidel", "mode7", "mode10"])
def test_cli_debug_equals_plain(argv, capsys):
    """The --debug CLI prints exactly the unchecked CLI's numbers on the
    paths through K2 (amg), K1's apply (Gauss-Seidel) and modes 7 and 10
    (the JAX CLI's checkify step compiles for minutes on the amg path, so
    this is held to the port's own unchecked run)."""
    argv = argv + ["--rows", "4", "--cols", "4", "--n-split", "2",
                   "--ntime", "2", "--device", "cpu", "--f64"]
    got = tcli.main(argv + ["--debug"])
    plain = tcli.main(argv)
    capsys.readouterr()
    for key in ("L1_error", "residual", "residual_history"):
        assert got[key] == plain[key], key


def test_cli_debug_nan_expression_raises():
    with np.errstate(invalid="ignore"), pytest.raises(FloatingPointError):
        tcli.run(["--mode", "9", "--rows", "3", "--cols", "3", "--ntime",
                  "1", "--ic", "sqrt(-1-x)", "--debug", "--device", "cpu"])

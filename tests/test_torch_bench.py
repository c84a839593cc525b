"""The port's bench (p_a_multigrids_tpu_torch/bench.py) == the JAX system's
root bench.py, function by function, on the CPU in float64: the residual
histories of ``_vcycle_stats`` (plus 1e-13 of the first residual) and
``_rho_linear`` to rel 1e-9 and
``_pcg_chain``'s iterations exactly, for the bench's configurations on
``tri_mesh(4, 4, 0.25, 0.25)`` at n_split 2, and one level-sweep row at
n_split 4 on ``tri_mesh(2, 2, 0.5, 0.5)``.  The root bench.py's
``_pcg_chain`` is a closure of its ``main``, compiled on its own by
``scripts/torch_record_bench.load_jax_bench``.  Then the repaired plateau
guard against bench.py's, and ``main`` on the CPU with the stand-in meshes
shrunk: one JSON line, exit 0 and the gate passed; with the amg solver
failing to build, ``rho`` null, the section's error and exit 1."""

import torch_threads  # noqa: F401

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from p_a_multigrids_tpu.config import SemiConfig as JConfig
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import semi as jsemi

from p_a_multigrids_tpu_torch import bench
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
MESH = (4, 4, 0.25, 0.25)
SWEEP_MESH = (2, 2, 0.5, 0.5)
RTOL = 1e-9
# a late residual, millions of times below the first, carries the float64
# rounding of b - A x at the first one's scale: held to rel 1e-9 plus this
# share of the first residual (~500 ulp)
ATOL_SHARE = 1e-13
CONFIGS = {"geometric": bench.GEOMETRIC, "amg": bench.AMG}


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jb():
    record = _load("torch_record_bench",
                   REPO / "scripts" / "torch_record_bench.py")
    return record.load_jax_bench()


def _norm_rel(want) -> float:
    """The largest relative distance the norms' tolerance allows one norm,
    which bounds the relative distance of a rho made from two."""
    return RTOL + ATOL_SHARE * want[0] / want.min()


def _solvers(mesh, **kw):
    """(JAX, port) solvers of one configuration in float64 on the CPU."""
    js = jsemi.SemiSolver(jsemi.build_problem(
        jstruct.tri_mesh(*mesh), JConfig(ntime=1, n_multigrid=1,
                                         dtype="float64", **kw)))
    ts = bench._solver_for(tstruct.tri_mesh(*mesh), device="cpu",
                           dtype="float64", **kw)
    return js, ts


@pytest.mark.parametrize("config", list(CONFIGS))
def test_vcycle_stats_matches_jax(jb, config):
    js, ts = _solvers(MESH, **CONFIGS[config])
    _, _, want = jb._vcycle_stats(js, n_time=1)
    per, rho, got = bench._vcycle_stats(ts, n_time=1)
    assert per > 0 and got.shape == (10,)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SHARE * want[0])
    assert rho == pytest.approx(bench._rho_from_history(want),
                                rel=_norm_rel(want))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_rho_linear_matches_jax(jb, config):
    js, ts = _solvers(MESH, **CONFIGS[config])
    want = jb._rho_linear(js)
    assert 0 < want < 1
    assert bench._rho_linear(ts) == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_pcg_chain_iterations_match_jax(jb, config):
    js, ts = _solvers(MESH, **CONFIGS[config])
    its, ms = bench._pcg_chain(ts)
    assert its == jb._pcg_chain(js)[0] and ms > 0


def test_sweep_row_matches_jax(jb, monkeypatch):
    """Level 3 of the sweep at n_split 4, made by the bench's own
    profiling.sweep_solver, against bench.py's sweep configuration."""
    monkeypatch.setattr(profiling, "SWEEP_MESH", SWEEP_MESH)
    ts = profiling.sweep_solver("cpu", 3, n_split=4, dtype="float64")
    js = jsemi.SemiSolver(jsemi.build_problem(
        jstruct.tri_mesh(*SWEEP_MESH), JConfig(
            dt=1e8, n_split=4, multi_levels=3, cheb_degree=6,
            cycle_type="w", ntime=1, n_multigrid=1, dtype="float64")))
    _, _, want = jb._vcycle_stats(js, n_rho=10, n_time=1)
    _, rho, got = bench._vcycle_stats(ts, n_rho=10, n_time=1)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SHARE * want[0])
    want_rho = bench._rho_from_history(want)
    assert rho == pytest.approx(want_rho, rel=_norm_rel(want))
    row = bench._sweep_row(ts, "deg6-w")
    assert row["rho"] == round(want_rho, 4) and row["config"] == "deg6-w"
    assert row["ms_to_1e6"] == pytest.approx(
        bench._t_to(row["ms_per_cycle"], row["rho"]), rel=1e-2)


class _History:
    """A stand-in solver for bench.py's ``_vcycle_stats`` whose cycles walk
    a given residual history: the state counts the cycles."""

    def __init__(self, norms):
        self.norms = jnp.asarray(norms)

    def initial_condition(self):
        return jnp.zeros(1)

    def _rhs(self, T):
        return T

    def _vcycle(self, li, x, b):
        return x + 1.0

    def residual(self, li, x, b, with_bc):
        return self.norms[x.astype(jnp.int32) - 1]


def _jax_rho(jb, norms) -> float:
    _, rho, seen = jb._vcycle_stats(_History(norms), n_rho=len(norms),
                                    n_time=1)
    np.testing.assert_array_equal(seen, norms)
    return rho


def test_single_spike_does_not_trim(jb):
    """One ratio above 0.9 (cycle 3) and then the fall goes on: bench.py's
    guard trims there, the port's takes every cycle."""
    h = [1.0, 0.3, 0.09, 0.085, 0.025, 0.0075, 0.00225, 6.75e-4, 2.0e-4,
         6.0e-5]
    assert _jax_rho(jb, h) == pytest.approx(h[3] / h[2], rel=1e-12)
    assert bench._rho_from_history(h) == pytest.approx(
        (h[-1] / h[2]) ** (1 / 7), rel=1e-12)


def test_true_plateau_trims_where_bench_py_does(jb):
    """From cycle 5 the residual stays on its floor: both guards trim
    there."""
    h = [1.0, 0.3, 0.09, 0.027, 0.0081, 0.0024, 0.00245, 0.0024, 0.00242,
         0.0024]
    want = _jax_rho(jb, h)
    assert want == pytest.approx((h[5] / h[2]) ** (1 / 3), rel=1e-12)
    assert bench._rho_from_history(h) == pytest.approx(want, rel=1e-12)


@pytest.fixture
def small_bench(monkeypatch):
    """main's stand-in meshes shrunk and each timed window cut to one
    call."""
    monkeypatch.setattr(bench, "BENCH_MESH", MESH)
    monkeypatch.setattr(profiling, "SWEEP_MESH", (1, 1, 1.0, 1.0))
    timed = bench._timed
    monkeypatch.setattr(bench, "_timed",
                        lambda step, x0, n, reps=3: timed(step, x0, 1, 1))


def _run(capsys) -> tuple:
    rc = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_main_prints_one_json_line(small_bench, capsys):
    rc, out = _run(capsys)
    extra = out["extra"]
    assert rc == 0 and extra["errors"] == {}
    assert out["metric"] == "time_per_vcycle_tri4x4_nsplit2"
    assert out["unit"] == "ms" and out["value"] > 0
    assert extra["ndof"] == 32 * 16 * 3
    assert extra["l1_gate_passed"] is True and extra["l1_err"] < 0.01
    assert extra["rho"] == extra["amg"]["rho"] and 0 < extra["rho"] < 1
    assert extra["amg"]["pcg_its_to_1e6"] > 0
    assert len(extra["geometric"]["residual_history"]) == 10
    # the CPU runs the kernels' plain versions
    assert (extra["k1_phase"], extra["k2_spmv"], extra["k1_tiers"]) == (
        False, False, [])
    assert set(extra["launches"].values()) == {0}
    assert extra["spmv_gnnz_s"] > 0 and extra["spmv_library_gnnz_s"] > 0
    sweep = extra["level_sweep_2split_nsplit5"]
    assert [k for k in sweep if k.isdigit()] == list("123456")
    assert all("rho" in v for k, v in sweep.items() if k != "max_over_"
               "min_ms_to_1e6")
    assert "untitled8192.msh" in extra["stand_in_for"]
    assert extra["device"].startswith("cpu")


def test_main_amg_failure_is_reported(small_bench, capsys, monkeypatch):
    build = bench._solver_for

    def failing(mesh, dt, device, dtype="float32", **kw):
        if kw.get("amg"):
            raise RuntimeError("amg build failed")
        return build(mesh, dt, device, dtype, **kw)

    monkeypatch.setattr(bench, "_solver_for", failing)
    rc, out = _run(capsys)
    extra = out["extra"]
    assert rc == 1
    assert extra["rho"] is None
    assert extra["amg"] == {"error": "RuntimeError: amg build failed"}
    assert extra["errors"] == {"amg": "RuntimeError: amg build failed"}
    assert extra["geometric"]["rho"] > 0 and extra["l1_gate_passed"]

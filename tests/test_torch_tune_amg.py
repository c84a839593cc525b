"""The port's knob sweep (p_a_multigrids_tpu_torch/tune_amg.py) == the JAX
system's scripts/tune_amg.py, case by case, on the CPU in float64: each
case's rho to rel 1e-9 of the script's own ``rho_linear`` and its PCG
iterations equal to ``pcg_ms``'s, both closures of the script's ``main``
compiled on their own by ``scripts/torch_record_tune_amg.load_tune_amg``
(its float32 draw cast to float64, as the pins' float64 run casts it), on
an RCM-reordered ``tri_mesh(4, 4, 0.25, 0.25)`` at n_split 2 (1,536 DOF;
``agg_target=8`` forms 67 aggregates).  Then ``main`` on the CPU with the
stand-in mesh shrunk: one JSON line with a row for every case, exit 0; and
with one configuration failing to build, those rows' errors, the line all
the same and exit 1."""

import torch_threads  # noqa: F401

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import pytest
import torch

from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.mesh import topology as jtopo

from p_a_multigrids_tpu_torch import bench, tune_amg
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.mesh import topology as ttopo

REPO = pathlib.Path(__file__).resolve().parents[1]
MESH = (4, 4, 0.25, 0.25)
RTOL = 1e-9
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def record():
    spec = importlib.util.spec_from_file_location(
        "torch_record_tune_amg",
        REPO / "scripts" / "torch_record_tune_amg.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_call_windows(monkeypatch):
    timed = bench._timed
    monkeypatch.setattr(bench, "_timed",
                        lambda step, x0, n, reps=3: timed(step, x0, 1, 1))


@pytest.mark.parametrize("case", range(len(tune_amg.CASES)),
                         ids=[name for name, _ in tune_amg.CASES])
def test_case_matches_the_script(record, one_call_windows, case):
    name, knobs = tune_amg.CASES[case]
    ts = record.load_tune_amg(jnp.float64)
    js = record.jax_solver(ts, jtopo.rcm_reorder(jstruct.tri_mesh(*MESH)),
                           knobs, "float64")
    want_rho, want_its = ts.rho_linear(js), ts.pcg_ms(js)[0]
    row = tune_amg.run_case(ttopo.rcm_reorder(tstruct.tri_mesh(*MESH)),
                            name, knobs, CPU, "float64")
    assert 0 < want_rho < 1
    assert row["rho"] == pytest.approx(want_rho, rel=RTOL)
    assert row["pcg_its_to_1e6"] == want_its
    assert row["ms_to_1e6"] == pytest.approx(
        bench._t_to(row["ms_per_cycle"], row["rho"]))
    assert row["ms_per_cycle"] > 0 and row["pcg_ms_to_1e6"] > 0
    assert row["setup_s"] > 0 and row["knobs"] == knobs
    # the CPU runs the kernels' plain versions
    assert row["launches"] == {"k1_phase": 0, "k2_rowop": 0}


@pytest.fixture
def small_sweep(monkeypatch, one_call_windows):
    monkeypatch.setattr(bench, "BENCH_MESH", MESH)


def _run(capsys) -> tuple:
    rc = tune_amg.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_main_prints_one_json_line(small_sweep, capsys):
    rc, out = _run(capsys)
    extra = out["extra"]
    assert rc == 0 and extra["errors"] == {}
    assert out["metric"] == "amg_knob_sweep"
    assert [r["name"] for r in out["cases"]] == [n for n, _ in
                                                 tune_amg.CASES]
    for row in out["cases"]:
        assert set(row) == {"name", "ms_per_cycle", "rho", "ms_to_1e6",
                            "pcg_its_to_1e6", "pcg_ms_to_1e6", "setup_s",
                            "launches", "knobs"}
        assert 0 < row["rho"] < 1 and row["pcg_its_to_1e6"] > 0
    assert extra["ndof"] == 32 * 16 * 3
    assert "untitled8192.msh" in extra["stand_in_for"]
    assert extra["device"].startswith("cpu")
    assert extra["launches"] == {"k1_phase": 0, "k2_rowop": 0}


def test_failed_case_is_reported(small_sweep, capsys, monkeypatch):
    build = tune_amg.solver

    def failing(mesh, knobs, device, dtype="float32"):
        if knobs.get("agg_target") == 8:
            raise RuntimeError("t8 build failed")
        return build(mesh, knobs, device, dtype)

    monkeypatch.setattr(tune_amg, "solver", failing)
    rc, out = _run(capsys)
    failed = [n for n, k in tune_amg.CASES if k.get("agg_target") == 8]
    assert rc == 1 and len(failed) == 2
    assert out["extra"]["errors"] == {
        n: "RuntimeError: t8 build failed" for n in failed}
    for row in out["cases"]:
        if row["name"] in failed:
            assert row == {"name": row["name"],
                           "error": "RuntimeError: t8 build failed"}
        else:
            assert 0 < row["rho"] < 1

"""The benchmark's harness on the CPU: discovery by name, the metrics'
arithmetic, the seeded traffic, a tiny cell end to end, the planted
faults that ``correct`` must catch, and the check that no run loads JAX
or the JAX package.

    python -m pytest -q pamg_bench/tests
"""

import json
import math
import statistics
import subprocess
import sys

import numpy as np
import pytest
import torch

from pamg_bench import run, spec, traffic, yardstick
from pamg_bench.reference import dg

from .conftest import PKG, ROOT

CELLS = ["tri8192_ns2.amg_pcg", "tri8192_ns2.geo_vcycle"]
SEED = 2 ** 31 + 977


# -- discovery ---------------------------------------------------------------

@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cells_found_by_name(workload, trace):
    cell = spec.load_cell(ROOT, workload, trace)
    bench = spec.load_benchmark(ROOT)
    names = [m for m, _, _ in cell.metrics]
    want = [m["name"] for m in spec.metrics_of(bench, workload, trace)]
    assert names == want and names
    assert cell.traffic["check"] in ("solve", "cycle")
    for name, _, mod in cell.metrics:
        entry = {m["name"]: m for m in bench["end_to_end"]
                 + bench["per_layer"]}[name]
        assert mod.SOURCE == entry["source"]
        assert mod.MOVES == entry.get("moves", name)


def test_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell's limits
    and a per-layer metric as new files and BENCHMARK.json entries; the
    harness's own files stay as they are."""
    from .conftest import make_tiny
    root = make_tiny(tmp_path)
    pkg = root / "pkg"
    conf = json.loads((pkg / "configs" / "tri8192_ns2.json").read_text())
    conf["semi"]["dtype"] = "float64"
    (pkg / "configs" / "tri_f64.json").write_text(json.dumps(conf))
    mix = json.loads((pkg / "traffic" / "amg_pcg.json").read_text())
    mix["semi"]["krylov_tol"] = 1e-8
    (pkg / "traffic" / "amg_tight.json").write_text(json.dumps(mix))
    (pkg / "limits" / "tri_f64.amg_tight.json").write_text(
        json.dumps({"rel_residual": 1e-6}))
    (pkg / "metrics" / "steps_traced.py").write_text(
        'LAYER = "time step"\nSOURCE = "program_counter"\n'
        'MOVES = "step_ms"\n\ndef read(record):\n'
        '    return float(record["steps"])\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tri_f64", "source": "x",
                             "file": "pkg/configs/tri_f64.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tri_f64.amg_tight",
                               "config": "tri_f64", "traffic": "amg_tight",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "time step", "moves": "step_ms",
                               "workloads": ["tri_f64.amg_tight"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in PKG.glob("*.py")}
    cell = spec.load_cell(root, "tri_f64.amg_tight", True, pkg)
    assert cell.semi_fields()["dtype"] == "float64"
    assert cell.semi_fields()["krylov_tol"] == 1e-8
    assert [m for m, _, _ in cell.metrics] == ["steps_traced"]
    out = run.run_cell("tri_f64.amg_tight", 5, 0.0, True, device="cpu",
                       root=root, pkg=pkg)
    assert out["metrics"]["steps_traced"]["value"] == 30.0
    assert out["correct"]
    assert before == {p: p.read_bytes() for p in PKG.glob("*.py")}


# -- metrics and the yardstick ----------------------------------------------

def _metric(name):
    return spec.load_metric(name)


def _kernel(name, ts, dur, *spans):
    return {"name": name, "ts": ts, "dur": dur,
            "cls": yardstick.kernel_class(name), "spans": set(spans)}


def test_end_to_end_arithmetic():
    steps = [0.010, 0.012, 0.011, 0.030] * 10
    rec = {"window_s": 0.5, "steps": 40, "step_s": steps,
           "memory_peak_bytes": 3 * 2 ** 20, "setup_s": 12.5}
    assert _metric("step_ms").read(rec) == pytest.approx(12.5)
    p95 = _metric("step_ms_p95").read(rec)
    assert p95 == pytest.approx(1e3 * statistics.quantiles(steps, n=20)[-1])
    assert p95 == pytest.approx(30.0)
    assert _metric("peak_device_mb").read(rec) == 3.0
    assert _metric("setup_s").read(rec) == 12.5
    assert _metric("step_ms_p95").read({"step_s": steps[:5]}) is None
    assert _metric("peak_device_mb").read({"memory_peak_bytes": 0}) is None


def test_per_layer_arithmetic():
    ks = [_kernel("void phase_kernel<float, 1>", 0.0, 10.0, "k1", "step"),
          _kernel("void phase_kernel<float, 1>", 20.0, 10.0, "k1", "step"),
          _kernel("rowop_lanes_kernel<float, 4>", 25.0, 5.0, "k2", "step"),
          _kernel("elementwise_kernel", 40.0, 4.0, "rhs", "step"),
          _kernel("reduce_kernel", 44.0, 6.0, "step")]
    # least bytes: two fine phases with z and one 13-slot rowop
    k1_bytes = 2 * yardstick.least_bytes(16, 8192, 4, 4)
    assert k1_bytes == 2 * (27 + 12) * 16 * 8192 * 4
    rec = {"kernels": ks, "steps": 2, "busy_us": yardstick.busy_us(
        [(k["ts"], k["dur"]) for k in ks]), "span_us": 50.0,
        "krylov": True, "krylov_its": 7,
        "calls": {"k1": 2, "k2": 1, "rhs": 1, "krylov": 2, "step": 2},
        "least_bytes": {"k1": k1_bytes, "k2": 3350}}
    assert rec["busy_us"] == 30.0          # 0-10, 20-30, 40-50
    assert _metric("device_idle_share").read(rec) == pytest.approx(40.0)
    assert _metric("launches_per_step").read(rec) == 2.5
    assert _metric("pcg_its_per_step").read(rec) == 3.5
    assert _metric("k1_hbm_roofline_share").read(rec) == pytest.approx(
        100 * k1_bytes / 3.35e12 / 20e-6)
    assert _metric("k2_hbm_roofline_share").read(rec) == pytest.approx(
        100 * 3350 / 3.35e12 / 5e-6)
    assert _metric("rhs_device_us_per_step").read(rec) == 2.0
    none = {**rec, "kernels": [], "least_bytes": {}, "krylov": False,
            "span_us": 0.0}
    for m in ("device_idle_share", "launches_per_step", "pcg_its_per_step",
              "k1_hbm_roofline_share", "k2_hbm_roofline_share",
              "rhs_device_us_per_step"):
        assert _metric(m).read(none) is None


def test_phase_planes_and_gaps():
    assert yardstick.phase_planes([], True) == 2
    assert yardstick.phase_planes([1.0] * 7, True) == 4
    assert yardstick.phase_planes([1.0] * 7, False) == 3
    iv = [(0.0, 10.0), (5.0, 10.0), (20.0, 5.0), (30.0, 1.0)]
    assert yardstick.busy_us(iv) == 21.0
    assert yardstick.idle_gaps(iv) == [(15.0, 5.0), (25.0, 5.0)]
    host = [(14.0, 10.0, "aten::item"), (16.0, 2.0, "k2"),
            (10.0, 30.0, "step")]
    assert yardstick.name_gaps(host, [(15.0, 5.0), (25.0, 5.0),
                                      (50.0, 1.0)]) == [
        "k2", "step", "python"]


def test_read_window_attributes_kernels_to_spans():
    events = [
        {"cat": "user_annotation", "name": "k1", "ts": 100, "dur": 20},
        {"cat": "user_annotation", "name": "step", "ts": 90, "dur": 100},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 105,
         "dur": 2, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150,
         "dur": 2, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "phase_kernel", "ts": 110, "dur": 30,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "vectorized_elementwise", "ts": 160,
         "dur": 3, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "FillFunctor<signed char>", "ts": 50,
         "dur": 1, "args": {"correlation": 3}},
        {"cat": "cpu_op", "name": "aten::mul", "ts": 149, "dur": 5},
    ]
    ks, host = yardstick.read_window(events, ("k1", "k2", "step"))
    assert [(k["name"], k["spans"]) for k in ks] == [
        ("phase_kernel", {"k1", "step"}),
        ("vectorized_elementwise", {"step"})]
    assert yardstick.missing_launches(ks, {"k1_phase": 1,
                                           "k2_rowop": 0}) is None
    assert "k1_phase" in yardstick.missing_launches(ks, {"k1_phase": 2})
    assert ("aten::mul" in [n for _, _, n in host])


# -- traffic -----------------------------------------------------------------

def test_initial_states_repeat_for_a_seed_and_differ_between_seeds():
    X = dg.structured_macro_X(6, 3, 0.5, 1 / 3)
    coords = dg.child_coords(X, 2)
    mix = json.loads((PKG / "traffic" / "amg_pcg.json").read_text())
    a = traffic.initial_states(coords, mix, SEED, "cpu", torch.float32)
    b = traffic.initial_states(coords, mix, SEED, "cpu", torch.float32)
    c = traffic.initial_states(coords, mix, SEED + 1, "cpu", torch.float32)
    assert a.shape == (mix["initial_states"], 36, 16, 3)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert traffic.episode_order(SEED, 8, "cpu") == traffic.episode_order(
        SEED, 8, "cpu")
    assert sorted(traffic.episode_order(SEED, 8, "cpu")) == list(range(8))
    # the states are continuous: nodes that coincide carry one value
    ids = dg._node_ids(coords.reshape(-1, 2, 3)).ravel()
    v = a[0].reshape(-1).double().numpy()
    lo = np.full(ids.max() + 1, np.inf)
    hi = np.full(ids.max() + 1, -np.inf)
    np.minimum.at(lo, ids, v)
    np.maximum.at(hi, ids, v)
    assert (hi - lo).max() < 1e-6


# -- a tiny cell end to end, and the faults it must catch --------------------

@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_runs_and_is_correct(tiny, workload):
    out = run.run_cell(workload, SEED, 0.5, False, device="cpu",
                       root=tiny, pkg=tiny / "pkg")
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) >= {"step_ms", "setup_s"}
    assert out["device"]["platform"] == "cpu"


def _unchanged(step):
    return lambda solver, T_t: T_t


def _altered(step):
    def broken(solver, T_t):
        out = step(solver, T_t).clone()
        out.view(-1)[out.numel() // 2] += 0.05 * out.abs().max()
        return out
    return broken


def _half(step):
    def broken(solver, T_t):
        out = step(solver, T_t).clone()
        half = out.shape[-1] // 2
        out[..., :half] = T_t[..., :half]
        return out
    return broken


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _altered, _half])
def test_planted_faults_are_not_correct(tiny, workload, fault, monkeypatch):
    """The timed path broken underneath, in the program's step: a step
    that returns its state unchanged, an answer altered where it is
    produced, half of the macros left unsolved."""
    from p_a_multigrids_tpu_torch.models import semi
    monkeypatch.setattr(semi.SemiSolver, "_step_t",
                        fault(semi.SemiSolver._step_t))
    out = run.run_cell(workload, SEED, 0.2, False, device="cpu",
                       root=tiny, pkg=tiny / "pkg")
    assert not out["correct"], out["compared"]


def test_traced_run_on_cpu_counts_calls(tiny):
    out = run.run_cell("tri8192_ns2.amg_pcg", SEED, 0.0, True,
                       device="cpu", root=tiny, pkg=tiny / "pkg")
    assert out["attempted"] == 30 and out["correct"]
    assert out["metrics"]["pcg_its_per_step"]["value"] > 0


def test_no_jax_after_a_run(tiny):
    code = (
        "import sys; from pathlib import Path; from pamg_bench import run;"
        f"root = Path({str(tiny)!r});"
        "run.run_cell('tri8192_ns2.geo_vcycle', 3, 0.2, False, "
        "device='cpu', root=root, pkg=root / 'pkg');"
        "print(run.forbidden_modules());"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'p_a_multigrids_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert res.stdout.split("\n")[:2] == ["[]", "[]"]
    assert "p_a_multigrids_tpu_torch" in run.sys.modules


def test_no_card_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                   "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_benchmark_imports_no_port_in_reference():
    for path in (PKG / "reference").glob("*.py"):
        text = path.read_text()
        assert "import p_a_multigrids" not in text
        assert "from p_a_multigrids" not in text


def test_large_seed_is_taken():
    g = traffic.generator(2 ** 31 + 12345, "cpu")
    assert math.isfinite(float(torch.rand(1, generator=g)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("trace", [0, 1])
def test_cli_on_the_card(cuda, trace):
    """The benchmark's own command on a cell at its real size: one JSON
    line, correct, on the GPU, the compared numbers last on stderr."""
    res = subprocess.run(
        [sys.executable, "-m", "pamg_bench.run", "--workload", CELLS[1],
         "--seed", str(SEED), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert res.stderr.strip().splitlines()[-1].startswith("compared ")

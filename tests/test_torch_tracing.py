"""The port's own spans, stages and counters (``utils.tracing``) on the
CPU: how the spans nest in a profiler's trace, the Krylov loops' host
sync count, the off path (no profiler: no clock read, no record range),
the set-up stages, the kernel-build counters, and the benchmark's
readers of them."""

import torch_threads  # noqa: F401

import json
import time

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu_torch.config import SemiConfig
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.ops import agg, krylov
from p_a_multigrids_tpu_torch.utils import cuda_build, tracing

from pamg_bench import spec

MESH = (6, 2, 0.25, 0.25)
# SA amg under PCG, as the benchmark's amg_pcg mix; geometric V(4,4)
# cycles over two levels, the coarse one solved by the dense inverse
AMG = dict(n_split=2, multi_levels=1, amg=True, agg_strength=0.5,
           cheb_degree=16, cheb_lower=0.05, krylov=True, krylov_tol=1e-6,
           dt=0.05)
CYCLE = dict(n_split=2, multi_levels=2, n_multigrid=2, dt=0.05)
SETUP_NESTED = ("pamg.setup.stencils", "pamg.setup.lam_max",
                "pamg.setup.coarse_inverse", "pamg.setup.sa_hierarchy",
                "pamg.setup.upload")


def _solver(**kw):
    cfg = SemiConfig(**kw)
    return semi.SemiSolver(semi.build_problem(structured.tri_mesh(*MESH),
                                              cfg), "cpu")


@pytest.fixture(scope="module")
def built():
    """The two solvers, with the stages of their builds."""
    tracing.reset()
    amg = _solver(**AMG)
    amg_stages = tracing.snapshot()["stages"]
    tracing.reset()
    cycle = _solver(**CYCLE)
    return amg, cycle, amg_stages, tracing.snapshot()["stages"]


def _state(solver):
    st = solver.stepper()
    rng = np.random.default_rng(3)
    T = solver.initial_condition()
    return st, st.to_state(T + torch.as_tensor(
        rng.normal(size=T.shape), dtype=T.dtype))


def _traced_step(solver, tmp_path):
    """One step under a CPU torch.profiler: the trace's record ranges as
    {name: [(start, end)]}, and the span aggregates."""
    st, S = _state(solver)
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        st.step(S)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                "pamg."):
            ts, dur = float(e["ts"]), float(e["dur"])
            ranges.setdefault(e["name"], []).append((ts, ts + dur))
    return ranges, tracing.snapshot()["spans"]


def _inside(ranges, child, parent):
    """Every range of ``child`` lies inside a range of ``parent``."""
    return all(any(a <= s and e <= b for a, b in ranges[parent])
               for s, e in ranges[child])


def test_spans_record_while_the_profiler_records():
    """The profiler's own flag turns the spans on: outside a profile every
    span is the one shared no-op context."""
    assert not tracing._recording()
    assert tracing.span("a") is tracing.span("b")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing._recording()
        assert tracing.span("a") is not tracing.span("a")
    assert not tracing._recording()


def test_spans_nest_in_an_amg_pcg_step(built, tmp_path):
    ranges, spans = _traced_step(built[0], tmp_path)
    for child, parent in [
            ("pamg.rhs", "pamg.step"), ("pamg.krylov", "pamg.step"),
            ("pamg.sync", "pamg.krylov"), ("pamg.vcycle.l0", "pamg.krylov"),
            ("pamg.sa", "pamg.vcycle.l0"), ("pamg.sa.l0", "pamg.sa"),
            ("pamg.k1", "pamg.step"), ("pamg.k2", "pamg.sa")]:
        assert _inside(ranges, child, parent), (child, parent)
    sa_levels = [n for n in ranges if n.startswith("pamg.sa.l")]
    for n in sa_levels[1:]:
        assert _inside(ranges, n, "pamg.sa.l0"), n
    # the aggregates count what the trace holds; a parent's self time
    # leaves its children out
    assert {n: len(r) for n, r in ranges.items()} == {
        n: a["calls"] for n, a in spans.items()}
    for n, a in spans.items():
        assert 0 <= a["self_us"] <= a["host_us"], n
    assert spans["pamg.step"]["self_us"] < spans["pamg.step"]["host_us"]


def test_spans_nest_in_a_bare_cycle_step(built, tmp_path):
    ranges, spans = _traced_step(built[1], tmp_path)
    for child, parent in [
            ("pamg.rhs", "pamg.step"), ("pamg.vcycle.l0", "pamg.step"),
            ("pamg.vcycle.l1", "pamg.vcycle.l0"),
            ("pamg.coarse", "pamg.vcycle.l1"),
            ("pamg.k1", "pamg.vcycle.l0")]:
        assert _inside(ranges, child, parent), (child, parent)
    assert spans["pamg.vcycle.l0"]["calls"] == CYCLE["n_multigrid"]
    assert not {"pamg.krylov", "pamg.sync", "pamg.sa", "pamg.k2"} & set(
        ranges)


def test_host_syncs_per_solve(built):
    """2 its + 1 reads a PCG solve (stop rule and breakdown flag an
    iteration, the stop rule at exit), none in a bare-cycle step."""
    amg, cycle = built[:2]
    for solver, syncs in ((amg, lambda its: 2 * its + 1),
                          (cycle, lambda its: 0)):
        st, S = _state(solver)
        for _ in range(3):
            c0 = dict(tracing.snapshot()["counters"])
            n0 = len(solver.krylov_iters)
            S = st.step(S)
            c1 = tracing.snapshot()["counters"]
            its = sum(solver.krylov_iters[n0:])
            assert c1["steps"] - c0.get("steps", 0) == 1
            assert c1.get("host_syncs", 0) - c0.get("host_syncs", 0) == \
                syncs(its)


def test_sa_cycle_runs_eagerly_on_the_cpu(built, monkeypatch):
    """On the CPU the SA cycles capture no graph: the hierarchy keeps
    none, the graph counters stay 0, and ``vcycle_iter`` and
    ``_agg_correct_t`` give the eager cycles' result bit for bit."""
    amg = built[0]
    h = amg.agg

    def eager(h, rc, ncycles=1):
        e = agg.vcycle(h, 0, rc)
        for _ in range(ncycles - 1):
            e = e + agg.vcycle(h, 0, rc - h.levels[0].op(e))
        return e

    rng = np.random.default_rng(5)
    rc = torch.tensor(rng.normal(size=(3, h.levels[0].n)),
                      dtype=amg.dtype)
    _, S = _state(amg)
    r_t = S - amg._apply_t(0, S)
    tracing.reset()
    got = [agg.vcycle_iter(h, rc, n) for n in (1, 2)]
    got.append(amg._agg_correct_t(0, S, r_t))
    counters = tracing.snapshot()["counters"]
    monkeypatch.setattr(agg, "vcycle_iter", eager)
    want = [eager(h, rc, n) for n in (1, 2)]
    want.append(amg._agg_correct_t(0, S, r_t))
    assert h.graphs == {}
    assert not {"sa_graph_captures", "sa_graph_replays",
                "sa_graph_k2_launches",
                "sa_graph_k2_least_bytes"} & set(counters)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_bicgstab_reads_once_an_iteration_and_at_exit():
    rng = np.random.default_rng(0)
    A = torch.tensor(np.eye(12) * 4 + rng.normal(size=(12, 12)) * 0.3)
    b = torch.tensor(rng.normal(size=12))
    tracing.reset()
    _, it, _ = krylov.bicgstab(lambda v: A @ v, b, torch.zeros_like(b),
                               tol=1e-10)
    assert 0 < it < 200
    assert tracing.snapshot()["counters"]["host_syncs"] == it + 1
    tracing.reset()
    _, it, _ = krylov.pcg(lambda v: A @ A.T @ v, b, torch.zeros_like(b),
                          tol=1e-10)
    assert tracing.snapshot()["counters"]["host_syncs"] == 2 * it + 1


def test_off_path_reads_no_clock_and_opens_no_range(built, monkeypatch):
    """Without a profiler a step enters no record range and reads no
    clock; the counters count, the span aggregates stay empty."""
    def refuse(*a, **k):
        raise AssertionError("called on the off path")

    st_amg, S_amg = _state(built[0])
    st_cyc, S_cyc = _state(built[1])
    tracing.reset()
    for owner in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(owner, "record_function", refuse)
    for name in ("perf_counter", "perf_counter_ns", "time", "time_ns",
                 "monotonic", "monotonic_ns"):
        monkeypatch.setattr(time, name, refuse)
    st_amg.step(S_amg)
    st_cyc.step(S_cyc)
    float(st_cyc.convergence(S_cyc))
    monkeypatch.undo()
    snap = tracing.snapshot()
    assert snap["counters"]["steps"] == 2
    assert snap["counters"]["host_syncs"] > 0
    assert snap["spans"] == {} and snap["stages"] == {}


def test_setup_stages(built):
    for stages, sa in ((built[2], True), (built[3], False)):
        want = {"pamg.setup.problem", "pamg.setup.solver", *SETUP_NESTED}
        if not sa:
            want.discard("pamg.setup.sa_hierarchy")
        assert want <= set(stages)
        assert all(s["s"] >= 0 and s["calls"] >= 1 for s in stages.values())
        nested = sum(stages[n]["s"] for n in SETUP_NESTED if n in stages)
        assert nested <= stages["pamg.setup.solver"]["s"]


def test_kernel_build_and_load_counters(monkeypatch, tmp_path):
    """A library built into an empty directory counts one build and one
    load, the same library again one load; each load is a stage."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    tracing.reset()
    cuda_build.load_host("gmsh_reader")
    snap = tracing.snapshot()
    assert snap["counters"] == {"kernel_loads": 1, "kernel_builds": 1}
    cuda_build.load_host("gmsh_reader")
    snap = tracing.snapshot()
    assert snap["counters"] == {"kernel_loads": 2, "kernel_builds": 1}
    assert snap["stages"]["pamg.setup.kernels"]["calls"] == 2


def test_snapshot_reads_the_kernel_counters():
    from p_a_multigrids_tpu_torch.ops import phase, spmv, transfer
    k = tracing.snapshot()["kernels"]
    assert k["k1_phase"] == phase.KERNEL.launches
    assert k["k1_rounds"] == phase.KERNEL.rounds
    assert k["k2_rowop"] == spmv.KERNEL.launches
    assert k["transfer"] == transfer.KERNEL.launches
    assert k["k1_by_tier"] == phase.KERNEL.by_tier
    assert k["k1_least_bytes_by_tier"] == phase.KERNEL.least_bytes_by_tier
    json.dumps(tracing.snapshot())


def _fake_kernel(monkeypatch):
    """A K1 instance whose library entry launches nothing and reports
    success, so that its counting runs on the CPU."""
    from p_a_multigrids_tpu_torch.ops import phase
    kernel = phase.PhaseKernel()
    monkeypatch.setattr(kernel, "function", lambda dtype: lambda *a: 0)
    return kernel


# (step sizes, want_z): the zero-round apply, a phase with and without z,
# and a phase longer than one launch takes (``ops.phase.MAX_ROUNDS``)
K1_CALLS = [([], True), ([0.5] * 6, True), ([0.5] * 6, False),
            ([0.5] * 70, True)]


def test_k1_least_bytes_by_tier_count_each_launch(built, monkeypatch):
    """K1's least bytes by tier grow on each launch by the bytes it must
    move (``utils.profiling.least_bytes``): a one-launch call by the
    call's own bytes, as a graph's capture reckons them (``ops.phase.
    watch``: 2 state planes for the apply, 3 for a phase, 4 with z); the
    launches of a longer phase each by 3 planes, its last with z by 4; in
    the tier of the plan alone."""
    from p_a_multigrids_tpu_torch.ops import phase
    from p_a_multigrids_tpu_torch.utils.profiling import least_bytes
    _, cycle, _, _ = built
    op = cycle.ops[0]
    kernel = _fake_kernel(monkeypatch)
    plan = phase.phase_plan(op.C, op.U, 132, 232_448, 2, tier="stream")
    x = torch.zeros((3, op.C, op.U))
    for coefs, want_z in K1_CALLS:
        before = dict(kernel.least_bytes_by_tier)
        chunks = phase._launch_rounds(tuple(coefs), want_z, torch.float32)
        n0 = kernel.by_tier["stream"]
        _, z = phase.launch_chunks(kernel, op, x, x, chunks, bool(coefs),
                                   want_z, plan, 0)
        added = {t: n - before[t]
                 for t, n in kernel.least_bytes_by_tier.items()}
        planes = 3 + int(want_z) if coefs else 2
        if len(chunks) == 1:
            want = least_bytes(op, 4, planes)
        else:
            want = (len(chunks) - 1) * least_bytes(op, 4, 3) + least_bytes(
                op, 4, planes)
        assert added == {"small": 0, "resident": 0, "stream": want}
        assert kernel.by_tier["stream"] - n0 == len(chunks)
        assert (z is None) is not want_z


def test_replay_credits_what_its_capture_counted(built, monkeypatch):
    """A CUDA graph's replay adds to each kernel what its capture's
    launches added (``ops.cuda_graph``: ``_counts`` before and after,
    ``_delta``, then ``_credit`` on each replay), K1's least bytes and
    launches by tier included."""
    from p_a_multigrids_tpu_torch.ops import cuda_graph, phase
    _, cycle, _, _ = built
    op = cycle.ops[0]
    captured = _fake_kernel(monkeypatch)
    before = cuda_graph._counts(captured)
    x = torch.zeros((3, op.C, op.U))
    for tier in ("small", "stream", "stream"):
        plan = phase.phase_plan(op.C, op.U, 132, 232_448, 2, tier=tier)
        for coefs, want_z in K1_CALLS:
            phase.launch_chunks(
                captured, op, x, x,
                phase._launch_rounds(tuple(coefs), want_z, torch.float32),
                bool(coefs), want_z, plan, 0)
    delta = cuda_graph._delta(cuda_graph._counts(captured), before)
    replayed = phase.PhaseKernel()
    for _ in range(3):
        cuda_graph._credit(replayed, delta)
    for name in phase.PhaseKernel.COUNTERS:
        got, once = getattr(replayed, name), getattr(captured, name)
        if isinstance(once, dict):
            assert got == {t: 3 * n for t, n in once.items()}, name
        else:
            assert got == 3 * once, name
    assert replayed.least_bytes_by_tier["stream"] == 2 * (
        replayed.least_bytes_by_tier["small"])


SNAP = {"counters": {"steps": 4, "host_syncs": 36, "sa_graph_replays": 20,
                     "sa_graph_k2_launches": 440,
                     "sa_graph_k2_least_bytes": 440 * 33_500,
                     "mg_graph_replays": 42, "mg_graph_k1_launches": 1260,
                     "mg_graph_k1_least_bytes": 1260 * 67_000,
                     "step_graph_replays": 3, "step_graph_k1_launches": 18,
                     "step_graph_k1_least_bytes": 18 * 134_000},
        "stages": {"pamg.setup.problem": {"calls": 1, "s": 2.5},
                   "pamg.setup.solver": {"calls": 1, "s": 9.0},
                   "pamg.setup.sa_hierarchy": {"calls": 1, "s": 6.0},
                   "pamg.setup.stencils": {"calls": 1, "s": 5.5}},
        "spans": {"pamg.step": {"calls": 5, "host_us": 9e4, "self_us": 1e3},
                  "pamg.sync": {"calls": 45, "host_us": 1500.0,
                                "self_us": 1500.0}},
        "kernels": {"transfer": 1304,
                    "k1_by_tier": {"small": 900, "resident": 12,
                                   "stream": 328},
                    "k1_least_bytes_by_tier": {
                        "small": 900 * 10_000, "resident": 12 * 5e6,
                        "stream": 328 * 33_500_000}}}
EMPTY = {"counters": {}, "stages": {}, "spans": {}, "kernels": {}}


@pytest.mark.parametrize("name,want", [
    ("host_syncs_per_step", 9.0), ("sync_wait_us_per_step", 300.0),
    ("setup_problem_s", 2.5), ("setup_solver_s", 9.0),
    ("setup_sa_hierarchy_s", 6.0), ("sa_graph_replays_per_step", 5.0),
    ("mg_graph_replays_per_step", 10.5),
    ("step_graph_replays_per_step", 0.75),
    ("transfer_launches_per_step", 326.0),
    ("k1_stream_launches_per_step", 82.0), ("setup_stencils_s", 5.5)])
def test_metric_reader(name, want, monkeypatch):
    """Each of the benchmark's readers of the program's snapshot, on a
    hand-made one; None where its denominator is 0 or its stage absent."""
    mod = spec.load_metric(name)
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAP)
    assert mod.read({}) == pytest.approx(want)
    monkeypatch.setattr(tracing, "snapshot", lambda: EMPTY)
    assert mod.read({}) is None


def test_graph_roofline_reader(monkeypatch):
    """``k2_graph_hbm_roofline_share`` takes the traced K2 kernels outside
    every ``k2`` span at the program's least bytes per replayed launch:
    two of 10 us at 33,500 bytes each is 0.1% of 3.35 TB/s; and
    ``k1_graph_hbm_roofline_share`` the K1 kernels outside every ``k1``
    span: two of 20 us at 67,000 bytes each is 0.1% too.  Each reads None
    without its counters or without such a kernel."""
    for name, cls, span, us in (("k2_graph_hbm_roofline_share", "k2_rowop",
                                 "k2", 10.0),
                                ("k1_graph_hbm_roofline_share", "k1_phase",
                                 "k1", 20.0)):
        mod = spec.load_metric(name)
        other = "k1_phase" if cls == "k2_rowop" else "k2_rowop"
        kernel = {"cls": cls, "dur": us, "spans": {"krylov", "step"}}
        record = {"kernels": [
            kernel, dict(kernel),
            {"cls": cls, "dur": 100.0, "spans": {span, "step"}},
            {"cls": other, "dur": 50.0, "spans": {"step"}}]}
        monkeypatch.setattr(tracing, "snapshot", lambda: SNAP)
        assert mod.read(record) == pytest.approx(0.1), name
        assert mod.read({"kernels": record["kernels"][2:]}) is None
        assert mod.read({}) is None
        monkeypatch.setattr(tracing, "snapshot", lambda: EMPTY)
        assert mod.read(record) is None


def test_step_graph_roofline_reader(monkeypatch):
    """``k1_step_graph_hbm_roofline_share`` takes the traced K1 kernels
    outside every ``k1`` span at the program's least bytes per launch of
    the bare step's graph: two of 40 us at 134,000 bytes each is 0.1% of
    3.35 TB/s.  It reads None without its counters (a program that
    replays no step, or has no such counters) or without such a kernel."""
    mod = spec.load_metric("k1_step_graph_hbm_roofline_share")
    kernel = {"cls": "k1_phase", "dur": 40.0, "spans": {"step"}}
    record = {"kernels": [
        kernel, dict(kernel),
        {"cls": "k1_phase", "dur": 100.0, "spans": {"k1", "step"}},
        {"cls": "k2_rowop", "dur": 50.0, "spans": {"step"}}]}
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAP)
    assert mod.read(record) == pytest.approx(0.1)
    assert mod.read({"kernels": record["kernels"][2:]}) is None
    assert mod.read({}) is None
    mg_only = {**SNAP, "counters": {k: v for k, v in SNAP["counters"].items()
                                    if not k.startswith("step_graph_")}}
    monkeypatch.setattr(tracing, "snapshot", lambda: mg_only)
    assert mod.read(record) is None
    monkeypatch.setattr(tracing, "snapshot", lambda: EMPTY)
    assert mod.read(record) is None


def test_stream_roofline_reader(monkeypatch):
    """``k1_stream_hbm_roofline_share`` takes the traced K1 kernels of the
    streaming tier (``phase_kernel<float, 2>``, eager or replayed alike)
    at the program's least bytes per streaming launch: two of 100 us at
    33,500,000 bytes each is 10% of 3.35 TB/s.  It reads None without K1's
    bytes by tier, or without such a kernel."""
    mod = spec.load_metric("k1_stream_hbm_roofline_share")
    name = ("void (anonymous namespace)::phase_kernel<float, {}>((anonymous "
            "namespace)::Args<float>)")
    kernel = {"name": name.format(2), "cls": "k1_phase", "dur": 100.0,
              "spans": {"step"}}
    record = {"kernels": [
        kernel, {**kernel, "spans": {"k1", "step"}},
        {**kernel, "name": name.format(1), "dur": 50.0},
        {"name": "rowop_lanes_kernel<float, 4>", "cls": "k2_rowop",
         "dur": 50.0, "spans": {"step"}}]}
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAP)
    assert mod.read(record) == pytest.approx(10.0)
    assert mod.read({"kernels": record["kernels"][2:]}) is None
    assert mod.read({}) is None
    monkeypatch.setattr(tracing, "snapshot", lambda: EMPTY)
    assert mod.read(record) is None

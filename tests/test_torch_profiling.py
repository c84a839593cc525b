"""Host-side pieces of the port's GPU profiler (no card needed)."""

import contextlib
import json

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu_torch.config import SemiConfig
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.ops import spmv
from p_a_multigrids_tpu_torch.utils import profiling


@pytest.mark.parametrize("n_split", [1, 2])
def test_least_bytes_counts_the_round_operands(n_split):
    """One coupling block a face (the nonzero Fp blocks of the faces inside
    a macro, the Xp blocks of the strip faces) and four state planes."""
    cfg = SemiConfig(n_split=n_split, multi_levels=1, dt=0.05)
    op = semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(4, 4, 0.25, 0.25), cfg), "cpu").ops[0]
    state = torch.empty((3, op.C, op.U))
    inner = int((op.Fp_t.abs().sum(dim=(1, 2)) > 0).sum())    # (f, c, u)
    assert inner == (3 * op.C - op.nb) * op.U
    want = (9 * inner + op.Xp_t.numel() + 4 * state.numel()) * 4
    assert profiling.least_bytes(op, 4) == want


def test_least_bytes_at_one_child_counts_no_fp():
    """At n_split 0 every face is a strip face: Fp is zero, Xp carries all
    the coupling (20.45 MB at U = 131,072, 6.10 us)."""
    cfg = SemiConfig(n_split=0, multi_levels=1, dt=0.05)
    op = semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(4, 4, 0.25, 0.25), cfg), "cpu").ops[0]
    assert op.C == 1 and op.nb == 3 and not bool(op.Fp_t.any())
    assert profiling.least_bytes(op, 4) == (op.Xp_t.numel() + 12 * op.U) * 4
    per_macro = profiling.least_bytes(op) / op.U
    assert profiling.bound_ms(per_macro * 131072) * 1e3 == pytest.approx(
        6.10, abs=0.01)


@pytest.mark.parametrize("n_split", [0, 2])
def test_apply_least_bytes_counts_x_in_and_z_out(n_split):
    """The zero-round apply z = -D^-1 A x needs the coupling blocks, x in
    and z out: two state planes, 33 floats a child at C > 1 (17.30 MB and
    5.16 us at C = 16, U = 8192)."""
    cfg = SemiConfig(n_split=n_split, multi_levels=1, dt=0.05)
    op = semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(4, 4, 0.25, 0.25), cfg), "cpu").ops[0]
    phase_bytes = profiling.least_bytes(op, 4)
    assert profiling.least_bytes(op, 4, planes=2) == \
        phase_bytes - 2 * 3 * op.C * op.U * 4
    if n_split == 2:
        per_macro = profiling.least_bytes(op, planes=2) / op.U
        assert per_macro == 33 * 16 * 4
        assert profiling.bound_ms(per_macro * 8192) * 1e3 == pytest.approx(
            5.16, abs=0.01)


@pytest.mark.parametrize("n_split", [0, 1, 2])
def test_stencil_bsr_matrix_is_the_zero_round_apply(n_split):
    """The zero-round apply's library yardstick computes the apply's z =
    -D^-1 A x: the same z as the plain K1 round with bp = 0, and -D^-1 of
    the level's assembled operator."""
    from p_a_multigrids_tpu_torch.ops import phase
    cfg = SemiConfig(n_split=n_split, multi_levels=1, dt=0.05,
                     dtype="float64")
    sv = semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(3, 2, 1 / 3, 0.5), cfg), "cpu")
    op = sv.ops[0]
    x = torch.tensor(np.random.default_rng(n_split).normal(
        size=(3, op.C, op.U)))
    A = profiling.stencil_bsr_matrix(op)
    E = op.C * op.U
    assert A.layout == torch.sparse_bsr and A.shape == (3 * E, 3 * E)
    got = (A @ x.reshape(3, E).T.reshape(-1)).reshape(E, 3).T
    want = phase.phase_reference(op, x, torch.zeros_like(x), [], True)[1]
    torch.testing.assert_close(got.reshape(3, op.C, op.U), want,
                               rtol=1e-12, atol=1e-12)
    ax = sv._apply_t(0, x)
    torch.testing.assert_close(-op.mul_self(got.reshape(x.shape)), ax,
                               rtol=1e-12, atol=1e-12)


def test_rowop_least_bytes_counts_tables_and_vectors():
    op = spmv.RowOp(np.zeros((5, 3), np.int64), np.ones((5, 3, 3, 3)), 7,
                    torch.float32, "cpu")
    tables = op.vals_t.numel() * 4 + op.cols_t.numel() * 4
    assert profiling.rowop_least_bytes(op, 4) == tables + (3 * 7 + 3 * 5) * 4


def test_rowop_least_bytes_skips_zero_blocks():
    """Padding slots (zero blocks) move no bytes the product needs."""
    vals = np.ones((5, 3, 3, 3))
    vals[1:, 2] = 0
    vals[4] = 0
    op = spmv.RowOp(np.zeros((5, 3), np.int64), vals, 7, torch.float32,
                    "cpu")
    slots = 3 + 2 * 3
    assert (profiling.rowop_least_bytes(op, 4)
            == slots * (9 * 4 + 4) + (3 * 7 + 3 * 5) * 4)


def test_bound_is_least_bytes_over_the_h100_memory_rate():
    """20.4 MB, the fine phase at C = 16, U = 8192, takes 6.1 us at least."""
    assert profiling.bound_ms(3.35e9) == pytest.approx(1.0)
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05)
    op = semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(4, 4, 0.25, 0.25), cfg), "cpu").ops[0]
    per_macro = profiling.least_bytes(op) / op.U
    assert profiling.bound_ms(per_macro * 8192) * 1e3 == pytest.approx(
        6.10, abs=0.01)


@pytest.mark.parametrize("variant", ["thread", "lanes"])
def test_bsr_matrix_equals_rowop_reference(variant):
    """The library yardstick's BSR matrix computes the RowOp's product,
    with rows padded by zero blocks on a repeated column and genuinely
    repeated columns merged by summing their blocks."""
    rng = np.random.default_rng(3)
    n_out, n_src, D = 9, 7, 10
    cols = rng.integers(0, n_src, size=(n_out, D))
    cols[:, 5:] = cols[:, :1]                 # zero padding on column 0
    cols[2, 1] = cols[2, 2]                   # a repeated real column
    vals = rng.normal(size=(n_out, D, 3, 3))
    vals[:, 5:] = 0.0
    op = spmv.RowOp(cols, vals, n_src, torch.float64, "cpu", variant)
    x = torch.tensor(rng.normal(size=(3, n_src)))
    A = profiling.bsr_matrix(op)
    assert A.layout == torch.sparse_bsr and A.shape == (3 * n_out, 3 * n_src)
    assert A.values().shape[0] < n_out * D    # padding and repeats merged
    got = (A @ x.T.reshape(-1)).reshape(n_out, 3).T
    want = spmv.rowop_reference(*op.tables(), x)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    dense = np.zeros((n_out, 3, n_src, 3))
    for n in range(n_out):
        for d in range(D):
            dense[n, :, cols[n, d], :] += vals[n, d]
    np.testing.assert_allclose(A.to_dense().numpy(),
                               dense.reshape(3 * n_out, 3 * n_src),
                               rtol=1e-14, atol=1e-14)


def test_kernel_class_and_busy_union():
    assert profiling.kernel_class("void (anonymous namespace)::phase_kernel"
                                  "<1>((anonymous namespace)::Args)") == \
        "k1_phase"
    assert profiling.kernel_class("(anonymous namespace)::rowop_kernel("
                                  "int const*, float const*)") == "k2_rowop"
    assert profiling.kernel_class("sm90_xmma_gemm_f32f32") == "gemm"
    assert profiling.kernel_class("at::native::reduce_kernel<512>") == \
        "reduction"
    assert profiling.kernel_class("vectorized_elementwise_kernel") == \
        "elementwise_copy_fill"
    # overlapping [0, 5) and [3, 8), then [10, 12): 8 + 2 busy
    ks = [("a", 3.0, 5.0), ("b", 0.0, 5.0), ("c", 10.0, 2.0)]
    assert profiling._busy_us(ks) == 10.0


def test_check_launches_raises_on_a_short_trace():
    ks = ([("phase_kernel<0>", 0.0, 1.0)] * 3
          + [("rowop_lanes_kernel<32>", 0, 1.0)])
    assert profiling._missing_launches(
        ks, {"k1_phase": 3, "k2_rowop": 1}) is None
    assert profiling._missing_launches(
        ks, {"k1_phase": 3, "k2_rowop": 2}) == \
        "traced 1 k2_rowop launches, the wrapper counted 2"


class _FakeProfile:
    """A stand-in for torch.profiler.profile whose steps do nothing."""

    def __init__(self, *a, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        pass


@pytest.mark.parametrize("fills", [2, 0])
def test_trace_helper_leaves_out_its_prime_fills(monkeypatch, fills):
    """_trace returns the traced kernels without the prime fills; a trace
    that holds none of them is taken again, and after TRACE_TRIES such
    traces it raises."""
    prime = f"vectorized_elementwise_kernel<{profiling.PRIME_KERNEL}>"
    block = [("phase_kernel<0>", 10.0, 1.0),
             ("vectorized_elementwise_kernel<FillFunctor<float>>", 12.0, 1.0)]
    tries = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(profiling, "_prime", lambda: None)
    monkeypatch.setattr(profiling, "MARGIN_S", 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    counts = {"k1_phase": 0, "k2_rowop": 0}
    monkeypatch.setattr(profiling, "_launch_counts", lambda: dict(counts))

    def fn():
        counts["k1_phase"] += 1

    def kernels(prof):
        tries.append(prof)
        return [(prime, float(i), 0.5) for i in range(fills)] + block

    monkeypatch.setattr(profiling, "_kernels", kernels)
    if fills:
        assert profiling._trace(fn, 1) == block
        assert len(tries) == 1
    else:
        with pytest.raises(RuntimeError, match="none of its prime fills"):
            profiling._trace(fn, 1)
        assert len(tries) == profiling.TRACE_TRIES


def test_cli_solver_is_the_cli_build():
    """The profiler's CLI solvers are built by the CLI's own setup."""
    argv = ["--mode", "9", "--rows", "4", "--cols", "4", "--levels", "1",
            "--amg"]
    sv = profiling.cli_solver(torch.device("cpu"), argv)
    assert sv.cfg.amg and sv.agg is not None and sv.ops[0].U == 32
    assert sv.cfg.agg_strength == 0.4 and sv.device.type == "cpu"


def test_sweep_solvers_are_the_bench_sweep(monkeypatch):
    """bench.py's level-sweep rows (n_split 5, dt 1e8, W-cycles, degree 6)
    and its production amg row, built here on a 4-macro mesh; the stand-in
    itself is 96 macros, 294,912 DOF at n_split 5."""
    rows, cols = profiling.SWEEP_MESH[:2]
    assert 2 * rows * cols * 4 ** 5 * 3 == 294912
    monkeypatch.setattr(profiling, "SWEEP_MESH", (2, 1, 0.5, 0.5))
    sv = profiling.sweep_solver("cpu", 3, coarse_operator="galerkin")
    c = sv.cfg
    assert (c.n_split, c.multi_levels, c.dt, c.cheb_degree, c.cycle_type,
            c.coarse_operator) == (5, 3, 1e8, 6, "w", "galerkin")
    assert [op.C for op in sv.ops] == [1024, 256, 64]
    amg = profiling.deep_amg_solver("cpu")
    c = amg.cfg
    assert (c.amg, c.agg_strength, c.cheb_degree, c.cheb_lower,
            c.cycle_type, c.multi_levels) == (True, 0.5, 16, 0.05, "v", 1)
    assert amg.agg is not None and amg.ops[0].C == 1024


def test_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profiling.main([])


def test_step_paths_are_the_cli_builds(tmp_path):
    """The profiler's mode-6 solver on a painted mesh runs the steps the
    CLI runs on the same mesh written as a gmsh file, and its mode-8
    solver carries the CLI run's inverse."""
    from p_a_multigrids_tpu_torch import __main__ as cli
    from p_a_multigrids_tpu_torch.mesh import gmsh
    from p_a_multigrids_tpu_torch.models import semi_assembled

    mesh = profiling.painted_mesh(8)
    assert set(np.unique(mesh.region_id)) == {1, 4}
    path = str(tmp_path / "painted.msh")
    gmsh.write_msh(path, mesh)
    argv = profiling.MODE6_ARGS + ["--mesh", path]
    sv = profiling.transport_solver("cpu", mesh, argv)
    assert sv.ops[0].C == 1 and sv.cfg.krylov and sv.cfg.theta == 0.5
    T = sv.run()
    out, T_cli, _ = cli.run(argv + ["--device", "cpu"])
    assert out["elements"] == 128
    torch.testing.assert_close(T, T_cli, rtol=0, atol=0)
    small = ["--mode", "8", "--rows", "4", "--cols", "4"]
    s8 = profiling.direct_solver("cpu", small)
    T0 = s8.initial_condition()
    T1 = semi_assembled.direct_step(s8, T0)
    _, T_cli, _ = cli.run(small + ["--ntime", "1", "--device", "cpu"])
    torch.testing.assert_close(T1, T_cli, rtol=0, atol=0)


def test_rect_step_is_the_cli_build():
    """The profiler's mode-1 step is the step the CLI runs."""
    from p_a_multigrids_tpu_torch import __main__ as cli
    argv = ["--mode", "1", "--rows", "20", "--cols", "2"]
    step, T0 = profiling.rect_step("cpu", argv)
    T = T0
    for _ in range(3):
        T = step(T)
    out, T_cli, _ = cli.run(argv + ["--device", "cpu"])
    assert out["ntime"] > 3
    from p_a_multigrids_tpu_torch.config import RectConfig
    from p_a_multigrids_tpu_torch.models import transport_rect
    _, T3, _, _ = transport_rect.solve(RectConfig(no_ele_row=20,
                                                  no_ele_col=2),
                                       device="cpu", ntime=3)
    torch.testing.assert_close(T, T3, rtol=0, atol=0)
    assert T_cli.shape == T.shape


@pytest.mark.parametrize("name,children,stencil", [
    ("GS_ARGS", 64, True), ("RICHARDSON_ARGS", 64, True)])
def test_menu_args_build_menu_solvers(name, children, stencil):
    """The solver menu's profiled command lines build stencil-path solvers
    that relax with the point smoothers, not the K1 phases."""
    sv = profiling.cli_solver("cpu", getattr(profiling, name))
    assert sv.p.levels[0]["C"] == children
    assert sv.stencil == stencil and not sv.phase_cycle


# -- the JAX package's helpers ------------------------------------------------

def test_timed_counts_as_jax():
    """timed's name, iterations and calls of fn are the JAX package's."""
    from p_a_multigrids_tpu.utils import profiling as jprof
    calls = {"port": 0, "jax": 0}

    def fn(key, x):
        calls[key] += 1
        return x + 1

    got = profiling.timed("port", fn, "port", torch.ones(3), iterations=5,
                          warmup=3)
    want = jprof.timed("jax", fn, "jax", np.ones(3), iterations=5, warmup=3)
    assert calls["port"] == calls["jax"] == 8
    assert (got.iterations, got.name) == (want.iterations, "port")
    assert got.seconds >= 0 and got.per_iter_ms == got.seconds / 5 * 1e3
    assert str(got).startswith("port: ") and str(got).endswith(" ms/iter")
    # a result with tensors in a tuple or dict synchronises as well
    assert profiling.timed("t", lambda: (torch.ones(2), {"a": torch.ones(1)}),
                           iterations=1, warmup=0).iterations == 1


@pytest.mark.parametrize("U,C,nloc,dtype_bytes",
                         [(8192, 16, 3, 4), (96, 1024, 3, 8)])
def test_operator_roofline_counts_as_jax(U, C, nloc, dtype_bytes):
    from p_a_multigrids_tpu.utils import profiling as jprof
    got = profiling.operator_roofline(U, C, nloc, 1e-4, dtype_bytes)
    want = jprof.operator_roofline(U, C, nloc, 1e-4, dtype_bytes)
    assert (got.flops, got.bytes_moved, got.seconds) == (
        want.flops, want.bytes_moved, want.seconds)
    assert got.achieved_gbps == want.achieved_gbps
    assert got.achieved_gflops == want.achieved_gflops


def test_roofline_summary_uses_the_h100_rate():
    r = profiling.Roofline(flops=2e9, bytes_moved=3.35e9, seconds=1e-3)
    assert r.summary() == ("2000.0 GFLOP/s, 3350.0 GB/s (100.0% of 3350 "
                           "GB/s peak)")
    assert r.summary(1675.0).endswith("(200.0% of 1675 GB/s peak)")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "a")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path == str(tmp_path / "a" / "trace.json")
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    assert profiling.trace_kernels(path) == []      # no device here
    with pytest.raises(KeyError):
        with profiling.trace(str(tmp_path), rank=3):
            raise KeyError("closed all the same")
    with open(tmp_path / "trace_rank3.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("raises", [False, True])
def test_trace_records_the_block_after_its_warm_up(tmp_path, raises):
    """The block runs in the recorded step, after the empty warm-up step
    and the idle margin: its events are in the trace, also when it
    raises; nothing of the warm-up step is."""
    with pytest.raises(KeyError) if raises else contextlib.nullcontext():
        with profiling.trace(str(tmp_path)) as path:
            with torch.profiler.record_function("the_block"):
                torch.ones(8) + 1
            if raises:
                raise KeyError("after the block")
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert names.count("the_block") == 1
    assert "ProfilerStep#1" in names and "ProfilerStep#0" not in names


def test_trace_kernels_reads_kernel_events(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "phase_kernel<1>", "ts": 5.0, "dur": 2.0},
        {"cat": "cpu_op", "name": "aten::add", "ts": 1.0, "dur": 1.0},
        {"cat": "kernel", "name": "rowop_lanes_kernel<4>", "ts": 9.0,
         "dur": 1.5}]}))
    ks = profiling.trace_kernels(str(path))
    assert ks == [("phase_kernel<1>", 5.0, 2.0),
                  ("rowop_lanes_kernel<4>", 9.0, 1.5)]
    assert profiling._missing_launches(
        ks, {"k1_phase": 1, "k2_rowop": 1}) is None

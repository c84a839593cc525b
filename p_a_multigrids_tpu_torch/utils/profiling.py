"""Device-time profile of the port on one GPU.

    python -m p_a_multigrids_tpu_torch.utils.profiling [--out FILE]

Seven measurements, each printed as a table and gathered into one JSON
object (printed last, and written to FILE when given); with ``--steps``
only the last two, ``steps`` and ``applies``:

- ``vcycle`` and ``amg_vcycle``: where one V-cycle spends its device time,
  by kernel class, with launches per cycle, the wall time per cycle by
  CUDA events, the host's enqueue time per cycle, and the device's idle
  share of the profiled window; for the bench-geometric configuration
  (``tri_mesh(128, 32, 3/128, 1/128)``, n_split 2, 2 levels, 393,216 DOF)
  and for the production amg configuration on the same mesh (``amg=True,
  agg_strength=0.5, cheb_degree=16, cheb_lower=0.05``, 1 level).
- ``sweep6_wcycle`` and ``deep_amg_vcycle``: the same for the deep split,
  the level sweep's 6-level W-cycle and its production amg row at n_split
  5 (``sweep_solver``, ``deep_amg_solver``: 294,912 DOF, C = 1024).
- ``phases``: the device time of one K1 launch (a 7-round phase with z,
  the fine degree-6 phase's shape) at each level K1 runs on in the
  bench-geometric configuration, in the CLI main path
  (``tri_mesh(24, 24, 1/24, 1/24)``, n_split 3, 4 levels), in the
  6-level sweep (C = 1024 to 4) and in mode 6 at n_split 0 (C = 1, U =
  131,072), with its tier and the cost of one more round, beside the least
  bytes a phase must move and the bound they give.
- ``choices``: the same phase in every K1 tier that fits each of those
  levels, and each rowop below in both K2 variants, beside the plans'
  choices.
- ``rowops``: the device time of one K2 launch for every block-row
  operator of the amg configuration's SA hierarchy and for mode 10's
  assembled operator (131,072 x 4), with its variant,
  beside its least bytes, its bound and the device time of the library
  call that computes the same product (``bsr_matrix``: a
  ``torch.sparse_bsr_tensor`` times a dense vector), with the names of the
  kernels that call ran.

- ``steps`` and ``applies`` (``--steps``): the same for one time step of
  each of the
  other modes' paths (``step_profiles``): mode 10's assembled sweeps and
  mode 7's explicit step at 393,216 DOF, mode 6 at n_split 0 (131,072
  elements), mode 9 with BiCGStab and with Crank-Nicolson at 221,184 DOF,
  mode 8's dense matrix-vector product at 38,400 DOF, the solver menu
  (the reference's Jacobi configuration at 393,216 DOF, colored
  Gauss-Seidel and Richardson at 221,184 DOF), the non-stencil path at
  n_split 7 (393,216 DOF) and mode 1 at 819,200 DOF; and the device time
  of one zero-round K1 apply on each level of the reference's Jacobi
  configuration, beside its bound and its library call
  (``apply_profiles``).

Device times come from ``torch.profiler`` kernel events, traced in windows
of at most ``WINDOW`` cycles; a window whose trace misses a K1 or K2
launch the wrappers counted is traced again, and after ``TRACE_TRIES``
such traces the profile raises.  Needs a CUDA device; without one it exits
non-zero.

The JAX package's helpers, for the card: ``timed`` (a ``Timing`` of a
callable, synchronised with the device its result lies on), ``trace`` (a
``torch.profiler`` trace of a block written as a Chrome trace; the CLI's
``--profile DIR``), ``trace_kernels`` (the device kernels of such a file),
and ``operator_roofline`` (a ``Roofline`` of one block-stencil apply, its
summary against the H100's ``HBM_BYTES_PER_S``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import warnings

import numpy as np
import torch

from ..config import SemiConfig
from ..mesh import structured
from ..models import semi
from ..ops import phase as K
from ..ops import spmv as K2
from ..ops.fused import to_t
from ..ops.spmv import RowOp
from ..ops.stencil import StencilOperator


# device memory rate of an H100 SXM (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Timing:
    name: str
    seconds: float
    iterations: int

    @property
    def per_iter_ms(self) -> float:
        return self.seconds / self.iterations * 1e3

    def __str__(self):
        return f"{self.name}: {self.per_iter_ms:.3f} ms/iter"


def _sync(out):
    """Wait for the CUDA devices the tensors of out (a tensor, or a
    tuple, list or dict of them) lie on; nothing for CPU tensors."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _sync(v)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)


def timed(name: str, fn, *args, iterations: int = 20, warmup: int = 2
          ) -> Timing:
    """Wall time of ``iterations`` calls of fn(*args) after ``warmup``
    calls, each end synchronised with the device of fn's result."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iterations):
        out = fn(*args)
    _sync(out)
    return Timing(name=name, seconds=time.perf_counter() - t0,
                  iterations=iterations)


# one-element fills that ``trace`` and ``_trace`` run before the block: in a
# process that had used the card for minutes, the H100's tracer dropped the
# first 19-42 kernels of every trace, whatever the margins, warm-up steps or
# idle time before them, and a trace that began with 64 or 512 fills kept
# every K1 and K2 launch after them (scripts/torch_trace_check.py).  They
# fill an int8 tensor, which nothing else here fills, so that ``_trace``
# can leave their kernels (PRIME_KERNEL in the name) out of its result.
TRACE_PRIME = 512
PRIME_KERNEL = "FillFunctor<signed char>"


def _prime():
    """TRACE_PRIME one-element int8 fills on this process's current CUDA
    device, finished before this returns; nothing where CUDA has not
    started."""
    if not _cuda_started():
        return
    one = torch.empty(1, dtype=torch.int8,
                      device=torch.cuda.current_device())
    for _ in range(TRACE_PRIME):
        one.fill_(1)
    torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str, rank: int | None = None):
    """A torch.profiler trace (the CPU, and the CUDA devices where there
    are any) of the block, written as a Chrome trace to
    ``logdir/trace.json``, or ``logdir/trace_rank<rank>.json`` for one rank
    of a distributed run, also when the block raises.  Yields the file's
    path.

    The trace holds every kernel the block launches: the profiler starts
    in an empty warm-up step and records from the next one, each after the
    process's CUDA device has finished its queued work and MARGIN_S of
    idle time (``_settle``); where CUDA has started, TRACE_PRIME
    one-element fills run and finish before the block, so the trace opens
    with them; and at the block's end the device is synchronised and idle
    MARGIN_S before the profiler stops."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json" if rank is None
                        else f"trace_rank{rank}.json")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, schedule=(
        torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)))
    prof.start()
    _settle()
    prof.step()
    _prime()
    _settle()
    try:
        yield path
    finally:
        _settle()
        prof.stop()
        prof.export_chrome_trace(path)


def _cuda_started() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _settle():
    """Wait for the work queued on this process's current CUDA device
    (each rank's own), where CUDA has started, then MARGIN_S more."""
    if _cuda_started():
        torch.cuda.synchronize()
    time.sleep(MARGIN_S)


def trace_kernels(path: str) -> list:
    """(name, start_us, duration_us) of every device kernel of a Chrome
    trace written by ``trace``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["dur"]) for e in events
            if e.get("cat") == "kernel"]


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_moved: float
    seconds: float

    @property
    def achieved_gflops(self) -> float:
        return self.flops / self.seconds / 1e9

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    def summary(self, peak_gbps: float = HBM_BYTES_PER_S / 1e9) -> str:
        return (f"{self.achieved_gflops:.1f} GFLOP/s, "
                f"{self.achieved_gbps:.1f} GB/s "
                f"({100 * self.achieved_gbps / peak_gbps:.1f}% of "
                f"{peak_gbps:.0f} GB/s peak)")


def operator_roofline(U: int, C: int, nloc: int, seconds: float,
                      dtype_bytes: int = 4) -> Roofline:
    """Roofline of one block-stencil operator apply, with the JAX
    package's counts: the self and three face blocks (nloc x nloc each) of
    every element read once, two flops a block entry, and the state
    counted three times."""
    E = U * C
    nnz = E * 4 * nloc * nloc
    return Roofline(flops=2.0 * nnz,
                    bytes_moved=dtype_bytes * (nnz + 3 * E * nloc),
                    seconds=seconds)


def least_bytes(op: StencilOperator, itemsize: int = 4,
                planes: int = 4) -> int:
    """Bytes one K1 launch on op must move at least, whatever its rounds:
    one premultiplied 3x3 coupling block a face, Fp across the 3C - nb
    faces inside a macro and Xp across the nb strip faces (27 values a
    child; Fp of a strip face is zero and not counted, so at C = 1, where
    every face is a strip face, only Xp), and ``planes`` state planes of 3
    values a child: a phase reads x0 and bp and writes x and z (4); the
    zero-round apply z = -D^-1 A x needs only x in and z out (2), so the
    bp it reads and the x it writes are its waste, not its bound.  Index
    tables not counted."""
    return (27 + 3 * planes) * op.C * op.U * itemsize


def rowop_least_bytes(op: RowOp, itemsize: int = 4) -> int:
    """Bytes one K2 launch must move at least: the tables' nonzero slots
    (9 values and one int32 column each; a zero block, such as a padding
    slot, adds nothing to y and is not counted), x read once and y
    written once."""
    vals = op.tables()[1]                                 # (D, 3, 3, N)
    slots = int((vals != 0).flatten(1, 2).any(1).sum())
    return (slots * (9 * itemsize + 4)
            + 3 * (op.n_src + op.n_out) * itemsize)


def bound_ms(nbytes: int) -> float:
    """The least time an H100 takes to move nbytes through device memory:
    the bound of a kernel whose bytes, not operations, limit it."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _bsr_tensor(rows, cols, blocks, n_rows: int, n_cols: int, device):
    """3x3 ``blocks`` at block positions (rows, cols) as a
    ``torch.sparse_bsr_tensor`` of shape (3 n_rows, 3 n_cols) on device.
    BSR wants sorted, unique columns in a row, so the blocks of a repeated
    position are summed."""
    keys, inv = np.unique(np.asarray(rows, np.int64) * n_cols + cols,
                          return_inverse=True)
    summed = np.zeros((len(keys), 3, 3), blocks.dtype)
    np.add.at(summed, inv.reshape(-1), blocks)
    crow = np.concatenate([[0], np.cumsum(np.bincount(keys // n_cols,
                                                      minlength=n_rows))])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # BSR support is "beta"
        return torch.sparse_bsr_tensor(
            torch.tensor(crow), torch.tensor(keys % n_cols),
            torch.tensor(summed), size=(3 * n_rows, 3 * n_cols),
            device=device, check_invariants=True)


def bsr_matrix(op: RowOp):
    """op as a ``torch.sparse_bsr_tensor`` of shape (3N, 3S) with 3x3
    blocks, on op's device: the library call that computes K2's product,
    ``bsr_matrix(op) @ x_t.T.reshape(3S)``, is K2's yardstick and nothing
    else (the port never calls it).  With a vector PyTorch dispatches to
    cuSPARSE's BSR matrix-vector product; a (3S, 1) matrix operand takes a
    slower gather and cuBLAS GEMV path instead.  RowOp's zero padding
    repeats a valid column, and is summed into it."""
    cols, vals = op.tables()
    cols = cols.T.cpu().numpy().astype(np.int64)            # (N, D)
    vals = vals.permute(3, 0, 1, 2).cpu().numpy()           # (N, D, 3, 3)
    N, D = cols.shape
    return _bsr_tensor(np.repeat(np.arange(N), D), cols.reshape(-1),
                       vals.reshape(-1, 3, 3), N, op.n_src,
                       op.vals_t.device)


def stencil_bsr_matrix(op: StencilOperator):
    """The function of K1's zero-round apply on op, z = -(D^-1 A) x, as a
    ``torch.sparse_bsr_tensor`` of shape (3E, 3E), E = C U, on op's device:
    the premultiplied blocks, negated (-I on the diagonal, -Fp across the
    faces inside a macro, -Xp across the strips), in the flat order
    (c U + u) 3 + i of ``x_t.reshape(3, E).T``.  The library call
    ``stencil_bsr_matrix(op) @ x`` (cuSPARSE's BSR matrix-vector product)
    is the zero-round apply's yardstick and nothing else (the port never
    calls it)."""
    C, U, E = op.C, op.U, op.C * op.U
    Fp = op.Fp_t.cpu().numpy()                              # (3f,3i,3j,C,U)
    child_rows = np.arange(E).reshape(C, U)                 # e = c U + u
    face_cols = (op.intra_rows.cpu().numpy().astype(np.int64)[:, :, None]
                 * U + np.arange(U))                        # (3f, C, U)
    rows = [np.arange(E), np.broadcast_to(child_rows, (3, C, U)).reshape(-1)]
    cols = [np.arange(E), face_cols.reshape(-1)]
    blocks = [np.broadcast_to(np.eye(3, dtype=Fp.dtype), (E, 3, 3)),
              Fp.transpose(0, 3, 4, 1, 2).reshape(-1, 3, 3)]
    if op.nb:
        bnd_c = op.bnd_c.cpu().numpy().astype(np.int64)     # (nb,)
        rows.append((bnd_c[:, None] * U + np.arange(U)).reshape(-1))
        cols.append(op.src_cu.cpu().numpy().astype(np.int64).reshape(-1))
        blocks.append(op.Xp_t.cpu().numpy().transpose(2, 3, 0, 1)
                      .reshape(-1, 3, 3))
    return _bsr_tensor(np.concatenate(rows), np.concatenate(cols),
                       -np.concatenate(blocks), E, E, op.Fp_t.device)


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel by its name."""
    low = name.lower()
    if "phase_kernel" in low:
        return "k1_phase"
    if "rowop" in low:
        return "k2_rowop"
    if "gemm" in low or "cutlass" in low or "cublas" in low:
        return "gemm"
    if "reduce" in low:
        return "reduction"
    return "elementwise_copy_fill"


def _kernels(prof) -> list:
    """(name, start_us, duration_us) of every device kernel in a trace.

    The profiler's step markers are mirrored onto the device timeline as
    annotations spanning the whole step; they are no kernels."""
    return [(e.name, e.time_range.start, e.time_range.elapsed_us())
            for e in prof.events()
            if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("ProfilerStep"))]


def _busy_us(kernels) -> float:
    """Length of the union of the kernels' intervals."""
    busy, end = 0.0, None
    for _, s, d in sorted(kernels, key=lambda k: k[1]):
        if end is None or s >= end:
            busy, end = busy + d, s + d
        elif s + d > end:
            busy, end = busy + (s + d - end), s + d
    return busy


# times a window is traced before a trace that misses launches the wrappers
# counted raises, and the idle host time at both ends of a traced step: on
# the H100 the tracer dropped kernel events near the edges of a step (1-18
# of 60-700 in a window, 18 of 50 short K2 launches three times running)
# until the steps had such margins; and a trace of one short library call
# came back empty three times running, so five tries
TRACE_TRIES = 5
MARGIN_S = 0.002


def _launch_counts() -> dict:
    """Launches by kernel class, the checked builds' (the same kernel
    names) included."""
    return {"k1_phase": K.KERNEL.launches + K.CHECKED.launches,
            "k2_rowop": K2.KERNEL.launches + K2.CHECKED.launches}


def _trace(fn, reps: int):
    """Device kernels of reps calls of fn, traced after one untraced
    profiler warm-up step of the same calls (the tracer can miss kernels
    launched just after it starts); each step opens with ``_prime``'s
    fills, which the result leaves out.  The trace must hold every K1 and
    K2 launch the wrappers counted in the traced step, some of the fills
    and some other kernel; one that misses any is taken again, and after
    TRACE_TRIES such traces this raises."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(TRACE_TRIES):
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):
                _prime()
                before = _launch_counts()
                # idle margins of host time at both ends of the step, so
                # that no kernel lies near its edges
                time.sleep(MARGIN_S)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(MARGIN_S)
                launched = {k: v - before[k]
                            for k, v in _launch_counts().items()}
                prof.step()
        traced = _kernels(prof)
        kernels = [k for k in traced if PRIME_KERNEL not in k[0]]
        if len(kernels) == len(traced):
            missing = "the trace holds none of its prime fills"
        elif not kernels:
            missing = "torch.profiler recorded no device kernel"
        else:
            missing = _missing_launches(kernels, launched)
        if missing is None:
            return kernels
    raise RuntimeError(missing)


def _missing_launches(kernels, launched: dict) -> str | None:
    """What the trace lacks of each kernel class's counted launches, or
    None when it holds them all."""
    for cls, n in launched.items():
        traced = sum(1 for name, _, _ in kernels if kernel_class(name) == cls)
        if traced != n:
            return f"traced {traced} {cls} launches, the wrapper counted {n}"
    return None


def event_ms(fn, reps: int) -> float:
    """Mean wall time of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_solver(device, **kw) -> semi.SemiSolver:
    """``bench.py``'s geometric configuration on its stand-in mesh
    (393,216 DOF); ``kw`` overrides SemiConfig fields (``stencil_probe``:
    the blocks probed from apply_A)."""
    cfg = SemiConfig(**{**dict(
        n_split=2, multi_levels=2, dt=0.05, ntime=1, n_multigrid=1,
        coarse_agg=False, coarse_cheb_degree=8, coarse_cheb_lower=0.02,
        coarse_pack=4), **kw})
    return semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(128, 32, 3 / 128, 1 / 128), cfg), device)


def amg_solver(device) -> semi.SemiSolver:
    """The production configuration (``bench.py``'s amg section) on the
    stand-in mesh: the SA hierarchy corrects the finest level."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05, ntime=1,
                     n_multigrid=1, amg=True, agg_strength=0.5,
                     cheb_degree=16, cheb_lower=0.05)
    return semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(128, 32, 3 / 128, 1 / 128), cfg), device)


# the level sweep's stand-in for the reference's 2_split.msh family: 96
# macros of isotropic right triangles on a 1 x 0.75 domain; at n_split 5,
# 294,912 DOF
SWEEP_MESH = (8, 6, 1 / 8, 1 / 8)


def sweep_solver(device, levels: int, **kw) -> semi.SemiSolver:
    """One row of ``bench.py``'s level sweep on the stand-in mesh: steady
    diffusion (dt = 1e8) at n_split 5 with ``levels`` geometric levels,
    W-cycles and degree-6 Chebyshev.  Below a geometric coarsest above the
    dense cap (levels 2-4) SA levels continue; levels 5-6 end in the dense
    coarse solve.  ``kw`` overrides SemiConfig fields."""
    cfg = SemiConfig(**{**dict(
        n_split=5, multi_levels=levels, dt=1e8, ntime=1, n_multigrid=1,
        cheb_degree=6, cycle_type="w"), **kw})
    return semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(*SWEEP_MESH), cfg), device)


def deep_amg_solver(device) -> semi.SemiSolver:
    """The level sweep's production row: the amg configuration at n_split 5
    on the stand-in mesh (the SA hierarchy of 98,304 elements corrects the
    finest level)."""
    return sweep_solver(device, 1, amg=True, agg_strength=0.5,
                        cheb_degree=16, cheb_lower=0.05, cycle_type="v")


# the CLI's geometric main path
CLI_MAIN = ["--mode", "9", "--rows", "24", "--cols", "24", "--n-split", "3",
            "--levels", "4", "--ntime", "2"]


def cli_solver(device, argv=CLI_MAIN) -> semi.SemiSolver:
    """The solver the CLI builds from ``argv`` (no ``--device``), on
    ``device``."""
    from .. import __main__ as cli
    return cli.setup(list(argv) + ["--device", str(device)])[2]


# The time-stepping paths of the other modes on the card, as CLI arguments
# (no --device): mode 10's assembled operator (K2 at 131,072 x 4) and mode
# 7's explicit step at 393,216 DOF (dt 5e-8: stable, the residual falls
# step by step, where 2e-7 grows 3x a step), mode 8 at the CLI defaults
# (38,400 DOF, a 5.9 GB dense inverse in float32), and mode 9 with
# BiCGStab (advection) and with Crank-Nicolson on the geometric CLI path
MODE10_ARGS = ["--mode", "10", "--rows", "128", "--cols", "32",
               "--n-split", "2", "--dt", "0.05", "--ntime", "2"]
MODE7_ARGS = ["--mode", "7", "--rows", "128", "--cols", "32", "--n-split",
              "2", "--dt", "5e-8", "--ntime", "10"]
MODE8_ARGS = ["--mode", "8"]
BICGSTAB_ARGS = CLI_MAIN + ["--u", "1", "0.5", "--krylov", "--krylov-tol",
                            "1e-6", "--dt", "0.01"]
THETA_ARGS = CLI_MAIN + ["--theta", "0.5"]
# mode 6 (n_split 0, one child an element) on painted_mesh(MODE6_N) as a
# gmsh file: Crank-Nicolson advection-diffusion through BiCGStab
MODE6_N = 256
MODE6_ARGS = ["--mode", "6", "--u", "1", "0", "--theta", "0.5", "--ntime",
              "2"]


# The solver menu and the non-stencil path (modes 9): the reference's
# active configuration (point Jacobi, omega 0.8, no surface terms, the
# corner-average restrictor) at 393,216 DOF; colored Gauss-Seidel and
# Richardson with surface terms on the geometric CLI path, at the omegas
# of the JAX package's tests/test_semi.py; Chebyshev through the fused
# operator at n_split 7 (8 macros of C = 16,384, 393,216 DOF)
REFERENCE9_ARGS = ["--mode", "9", "--rows", "128", "--cols", "32",
                   "--n-split", "2", "--levels", "2", "--solver", "jacobi",
                   "--omega", "0.8", "--no-surface-terms", "--restrictor",
                   "corner_average", "--n-multigrid", "6", "--ntime", "2"]
GS_ARGS = CLI_MAIN + ["--solver", "gauss_seidel", "--omega", "0.5"]
RICHARDSON_ARGS = CLI_MAIN + ["--solver", "richardson", "--omega", "0.01"]
NSPLIT7_ARGS = ["--mode", "9", "--rows", "2", "--cols", "2", "--n-split",
                "7", "--levels", "3", "--ntime", "2"]
# mode 1 at width: 200 x 1024 quads (819,200 DOF), 714 steps
MODE1_ARGS = ["--mode", "1", "--rows", "200", "--cols", "1024"]


def painted_mesh(n: int):
    """tri_mesh(n, n) on the unit square with the macros whose centroid
    lies in [0.2, 0.45] x [0.3, 0.7] in region 4, where the CLI's initial
    condition is 1 (0 elsewhere)."""
    mesh = structured.tri_mesh(n, n, 1.0 / n, 1.0 / n)
    x, y = mesh.X.mean(axis=2).T
    mesh.region_id = np.where((x > 0.2) & (x < 0.45) & (y > 0.3)
                              & (y < 0.7), 4, 1).astype(np.int32)
    return mesh


def transport_solver(device, mesh, argv=MODE6_ARGS) -> semi.SemiSolver:
    """The solver of a transport mode (2-6) that the CLI runs from ``argv``
    (no --device) on ``mesh``, on ``device`` (its steps after a Rannacher
    start)."""
    from .. import __main__ as cli
    from ..config import ProblemFns
    from ..models import transport
    args, _ = cli._parse(list(argv) + ["--device", str(device)])
    return semi.SemiSolver(semi.build_problem(mesh, transport._semi_cfg(
        cli._transport_cfg(args), ProblemFns())), device)


def direct_solver(device, argv=MODE8_ARGS):
    """Mode 8's solver (with its dense inverse ``Ainv``) as the CLI builds
    and runs it from ``argv`` (no --device), on ``device``."""
    from .. import __main__ as cli
    return cli.run(list(argv) + ["--device", str(device)])[2]


# cycles a trace window holds at most: longer windows lost kernel events
# on the deep W-cycles (14 of 3,500 at 20 cycles of the 4-level sweep)
WINDOW = 5


def window_profile(fn, calls: int, window: int = WINDOW) -> dict:
    """Device time of ``calls`` calls of fn by kernel class, traced in
    windows of at most ``window`` calls and summed, with launches per call,
    the wall time per call by CUDA events and the host's enqueue time per
    call; busy and span are summed over the windows, so the idle share
    leaves out the gaps between them.  fn is called 3 times first."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall_ms = event_ms(fn, calls)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    kernels, busy, span = [], 0.0, 0.0
    for w in range(0, calls, window):
        traced = _trace(fn, min(window, calls - w))
        kernels += traced
        busy += _busy_us(traced)
        span += (max(s + d for _, s, d in traced)
                 - min(s for _, s, _ in traced))
    by_class: dict[str, dict] = {}
    for name, _, d in kernels:
        c = by_class.setdefault(kernel_class(name),
                                {"device_us": 0.0, "launches": 0})
        c["device_us"] += d / calls
        c["launches"] += 1
    for c in by_class.values():
        c["launches"] /= calls
    return {"cycles": calls, "by_class": by_class,
            "device_busy_us": busy / calls,
            "device_span_us": span / calls,
            "device_idle_share": 1.0 - busy / span,
            "wall_ms_cuda_events": wall_ms,
            "host_enqueue_ms": enqueue_ms}


def vcycle_profile(solver: semi.SemiSolver, cycles: int = 20) -> dict:
    """``window_profile`` of ``cycles`` cycles of solver from T0."""
    b_t = solver._rhs_t(to_t(solver.initial_condition()))
    state = {"x": to_t(solver.initial_condition())}

    def cycle():
        state["x"] = solver._vcycle_t(0, state["x"], b_t)

    return window_profile(cycle, cycles)


def step_profiles(device, steps: int = 3) -> dict:
    """``window_profile`` of one time step, repeated from the initial
    condition, of each stepping path beside the V-cycles: modes 6, 7, 8, 10
    and mode 9 with BiCGStab and with Crank-Nicolson, one step a trace
    window, with the Krylov iterations a step where there are any."""
    from ..models import semi_assembled
    out = {}
    makers = {
        "mode10": lambda: cli_solver(device, MODE10_ARGS),
        "mode7": lambda: cli_solver(device, MODE7_ARGS),
        "mode9_bicgstab": lambda: cli_solver(device, BICGSTAB_ARGS),
        "mode9_theta_half": lambda: cli_solver(device, THETA_ARGS),
        "mode6": lambda: transport_solver(device, painted_mesh(MODE6_N)),
        "mode9_reference_jacobi": lambda: cli_solver(device,
                                                     REFERENCE9_ARGS),
        "mode9_gauss_seidel": lambda: cli_solver(device, GS_ARGS),
        "mode9_richardson": lambda: cli_solver(device, RICHARDSON_ARGS),
        "mode9_n_split7": lambda: cli_solver(device, NSPLIT7_ARGS)}
    for name, make in makers.items():
        sv = make()
        T0 = sv.initial_condition()
        if name == "mode10":
            fn = lambda: sv._step(T0)
        else:
            T0_t = to_t(T0)
            fn = lambda: sv._step_t(T0_t)
        out[name] = window_profile(fn, steps, window=1)
        out[name].update(dof=3 * sv.p.levels[0]["C"] * sv.p.num_macro,
                         krylov_iterations=sorted(set(sv.krylov_iters)))
    solver = direct_solver(device)
    T0 = solver.initial_condition()
    out["mode8"] = window_profile(
        lambda: semi_assembled.direct_step(solver, T0), steps, window=1)
    out["mode8"].update(dof=3 * solver.ops[0].C * solver.ops[0].U,
                        krylov_iterations=[])
    step, T0 = rect_step(device)
    out["mode1"] = window_profile(lambda: step(T0), steps, window=1)
    out["mode1"].update(dof=T0.numel(), krylov_iterations=[])
    return out


def apply_profiles(device, reps: int = 50) -> dict:
    """``phase_profile`` of the zero-round K1 apply (one round: z) on each
    level of the reference's Jacobi configuration (REFERENCE9_ARGS: C = 16
    and 4, U = 8192), the operator apply of the point smoothers, with the
    apply's own least bytes (x in, z out) and the device time of the
    library call that computes the same z, ``stencil_bsr_matrix(op) @ x``."""
    sv = cli_solver(device, REFERENCE9_ARGS)
    out = {}
    for li, op in enumerate(sv.ops):
        r = out[f"ref9_L{li}"] = phase_profile(op, rounds=1, planes=2)
        A = stencil_bsr_matrix(op)
        xv = torch.randn(A.shape[1], generator=torch.Generator().manual_seed(
            0)).to(device)
        lib = _trace(lambda: A @ xv, reps)
        r.update(library_us=sum(d for _, _, d in lib) / reps,
                 library_kernels=sorted({name for name, _, _ in lib}))
    return out


def rect_step(device, argv=MODE1_ARGS):
    """(step, T0): mode 1's step on the problem the CLI builds from
    ``argv`` (no --device), on ``device``, and its initial box."""
    from .. import __main__ as cli
    from ..config import RectConfig
    from ..models import transport_rect
    args, _ = cli._parse(list(argv) + ["--device", str(device)])
    problem = transport_rect.build_problem(RectConfig(
        no_ele_row=args.rows, no_ele_col=args.cols), device)
    step, _ = transport_rect.make_step(problem)
    return step, transport_rect.initial_condition(problem)


def phase_profile(op: StencilOperator, rounds: int = 7, reps: int = 20,
                  tier: str | None = None, planes: int = 4) -> dict:
    """Device time of one K1 launch on op, in ``tier`` when given: a phase
    of ``rounds`` rounds with z (coef 0, so the state stays finite), beside
    its least bytes (``least_bytes`` with ``planes``) and bound."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, op.C, op.U), generator=g).to(op.Fp_t.device)
    bp = torch.randn((3, op.C, op.U), generator=g).to(op.Fp_t.device)
    run = lambda: K.phase_on_tier(op, x, bp, [0.0] * (rounds - 1), True,
                                  tier)
    run()
    torch.cuda.synchronize()
    wall_ms = event_ms(run, reps)
    kernels = [k for k in _trace(run, reps)
               if kernel_class(k[0]) == "k1_phase"]
    dev_us = sum(d for _, _, d in kernels) / reps
    nbytes = least_bytes(op, x.element_size(), planes)
    return {"C": op.C, "U": op.U, "nb": op.nb, "rounds": rounds,
            "tier": K.KERNEL.plan(op, tier).tier,
            "device_us_per_phase": dev_us,
            "wall_us_per_phase": wall_ms * 1e3,
            "least_bytes": nbytes, "bound_us": bound_ms(nbytes) * 1e3,
            "effective_GBps": nbytes / (dev_us * 1e-6) / 1e9}


def rowop_profile(op: RowOp, reps: int = 50) -> dict:
    """Device time of one K2 launch on op and of the library call
    ``bsr_matrix(op) @ x`` on the same vector, beside op's least bytes and
    bound."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, op.n_src), generator=g).to(op.vals_t.device)
    run = lambda: op(x)
    run()
    torch.cuda.synchronize()
    kernels = [k for k in _trace(run, reps)
               if kernel_class(k[0]) == "k2_rowop"]
    dev_us = sum(d for _, _, d in kernels) / reps
    A, xv = bsr_matrix(op), x.T.reshape(-1).contiguous()
    lib = _trace(lambda: A @ xv, reps)
    nbytes = rowop_least_bytes(op, x.element_size())
    return {"N": op.n_out, "D": op.D, "S": op.n_src,
            "variant": op.variant, "lanes": op.lanes,
            "device_us": dev_us, "least_bytes": nbytes,
            "bound_us": bound_ms(nbytes) * 1e3,
            "effective_GBps": nbytes / (dev_us * 1e-6) / 1e9,
            "library_us": sum(d for _, _, d in lib) / reps,
            "library_kernels": sorted({name for name, _, _ in lib})}


def choices_profile(levels: dict, rowops: dict) -> dict:
    """What the plans' choices cost against the alternatives: device us of
    a 7-round K1 phase in every tier that fits each level, and of a K2
    apply in both variants of each rowop (a copy of the tables in the other
    variant), beside the choice."""
    out = {"phases": {}, "rowops": {}}
    for name, op in levels.items():
        row = out["phases"][name] = {"chosen": K.KERNEL.plan(op).tier}
        for tier in K.TIERS:
            try:
                K.KERNEL.plan(op, tier)
            except ValueError:          # the level does not fit the tier
                continue
            row[tier] = phase_profile(op, tier=tier)["device_us_per_phase"]
    for name, op in rowops.items():
        row = out["rowops"][name] = {"chosen": op.variant}
        cols, vals = op.tables()
        for variant in ("thread", "lanes"):
            twin = RowOp(cols.T.cpu().numpy(),
                         vals.permute(3, 0, 1, 2).cpu().numpy(), op.n_src,
                         vals.dtype, vals.device, variant)
            row[variant] = rowop_profile(twin)["device_us"]
    return out


def _print_vcycle(title: str, v: dict):
    print(f"{title}, {v['cycles']} cycles")
    print(f"{'class':24s} {'device us/cycle':>16s} {'launches/cycle':>15s}")
    for name, c in sorted(v["by_class"].items()):
        print(f"{name:24s} {c['device_us']:16.2f} {c['launches']:15.1f}")
    print(f"device busy {v['device_busy_us']:.2f} us/cycle, span "
          f"{v['device_span_us']:.2f} us/cycle, idle share "
          f"{v['device_idle_share']:.4f}; wall {v['wall_ms_cuda_events']:.4f}"
          f" ms/cycle (CUDA events), host enqueue "
          f"{v['host_enqueue_ms']:.4f} ms/cycle")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="p_a_multigrids_tpu_torch.utils.profiling")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--steps", action="store_true",
                    help="profile only the time steps of modes 6-10 "
                         "(step_profiles)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device is available")
    dev = torch.device("cuda", 0)
    if args.steps:
        out = {"device": torch.cuda.get_device_name(0),
               "steps": step_profiles(dev),
               "applies": apply_profiles(dev)}
        for name, v in out["steps"].items():
            _print_vcycle(f"{name} step ({v['dof']} DOF, Krylov iterations "
                          f"{v['krylov_iterations']})", v)
        for name, r in out["applies"].items():
            print(f"zero-round apply {name}: C {r['C']} U {r['U']} "
                  f"{r['tier']} {r['device_us_per_phase']:.2f} us device, "
                  f"{r['wall_us_per_phase']:.2f} us wall, bound "
                  f"{r['bound_us']:.2f} us, library {r['library_us']:.2f} "
                  f"us {r['library_kernels']}")
        return _emit(out, args.out)
    bench, cli, amg = bench_solver(dev), cli_solver(dev), amg_solver(dev)
    sweep6, deep_amg = sweep_solver(dev, 6), deep_amg_solver(dev)
    out = {"device": torch.cuda.get_device_name(0),
           "vcycle": vcycle_profile(bench), "amg_vcycle": vcycle_profile(amg),
           "sweep6_wcycle": vcycle_profile(sweep6),
           "deep_amg_vcycle": vcycle_profile(deep_amg),
           "phases": {}, "rowops": {}}
    _print_vcycle("bench-geometric V-cycle", out["vcycle"])
    _print_vcycle("production amg V-cycle", out["amg_vcycle"])
    _print_vcycle("level sweep, 6-level W-cycle", out["sweep6_wcycle"])
    _print_vcycle("level sweep, amg V-cycle", out["deep_amg_vcycle"])
    mode6 = transport_solver(dev, painted_mesh(MODE6_N))
    rowops = dict(amg.agg.rowops(), mode10_A=cli_solver(dev, MODE10_ARGS).A)
    levels = {f"bench_L{i}": op for i, op in enumerate(bench.ops)}
    levels.update({f"cli_L{i}": op for i, op in enumerate(cli.ops)
                   if op.C > 1})
    levels.update({f"sweep_L{i}": op for i, op in enumerate(sweep6.ops)
                   if op.C > 1})
    levels["mode6_L0"] = mode6.ops[0]
    print(f"{'level':10s} {'C':>4s} {'U':>5s} {'nb':>3s} {'tier':>8s} "
          f"{'dev us/phase':>13s} {'us/round':>9s} {'wall us/phase':>14s} "
          f"{'least MB':>9s} {'bound us':>9s}")
    for name, op in levels.items():
        r = out["phases"][name] = phase_profile(op)
        # the cost of one more round: phases of 2 and 16 rounds
        r["device_us_per_round"] = (
            phase_profile(op, 16)["device_us_per_phase"]
            - phase_profile(op, 2)["device_us_per_phase"]) / 14
        print(f"{name:10s} {r['C']:4d} {r['U']:5d} {r['nb']:3d} "
              f"{r['tier']:>8s} {r['device_us_per_phase']:13.2f} "
              f"{r['device_us_per_round']:9.2f} "
              f"{r['wall_us_per_phase']:14.2f} {r['least_bytes'] / 1e6:9.2f}"
              f" {r['bound_us']:9.2f}")
    print(f"{'rowop':12s} {'N':>7s} {'D':>4s} {'S':>7s} {'variant':>8s} "
          f"{'dev us':>8s} {'least MB':>9s} {'bound us':>9s} {'lib us':>8s}")
    for name, op in rowops.items():
        r = out["rowops"][name] = rowop_profile(op)
        print(f"{name:12s} {r['N']:7d} {r['D']:4d} {r['S']:7d} "
              f"{r['variant']:>8s} {r['device_us']:8.2f} "
              f"{r['least_bytes'] / 1e6:9.2f} {r['bound_us']:9.2f} "
              f"{r['library_us']:8.2f}")
    print("library kernels:", sorted({k for r in out["rowops"].values()
                                      for k in r["library_kernels"]}))
    out["choices"] = choices_profile(levels, rowops)
    for kind, rows in out["choices"].items():
        for name, row in rows.items():
            print(f"choice {kind} {name}: " + " ".join(
                f"{k}={v if isinstance(v, str) else f'{v:.2f}'}"
                for k, v in row.items()))
    return _emit(out, args.out)


def _emit(out: dict, path: str | None) -> dict:
    """Print the JSON object (and write it to path when given)."""
    text = json.dumps(out)
    if path:
        with open(path, "w") as f:
            f.write(text + "\n")
    print(text)
    return out


if __name__ == "__main__":
    main()

"""Device-time profile of the port on one GPU.

    python -m p_a_multigrids_tpu_torch.utils.profiling [--out FILE]

Five measurements, each printed as a table and gathered into one JSON
object (printed last, and written to FILE when given):

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
- ``rounds``: the device time of one K1 round at each level K1 runs on in
  the bench-geometric configuration, in the CLI main path
  (``tri_mesh(24, 24, 1/24, 1/24)``, n_split 3, 4 levels) and in the
  6-level sweep (C = 1024 to 4), beside the least bytes a round must move
  and the rate that implies.
- ``rowops``: the device time of one K2 launch for every block-row
  operator of the amg configuration's SA hierarchy, beside its least bytes.

Device times come from ``torch.profiler`` kernel events.  Needs a CUDA
device; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import SemiConfig
from ..mesh import structured
from ..models import semi
from ..ops import phase as K
from ..ops import spmv as K2
from ..ops.fused import to_t
from ..ops.spmv import RowOp
from ..ops.stencil import StencilOperator


def least_bytes(op: StencilOperator, itemsize: int = 4) -> int:
    """Bytes one K1 round must move at least: the premultiplied face planes
    Fp (27 per child), the slot blocks Xp (9 per slot), and the four state
    planes x, bp, x_out, z (3 per child); index tables not counted."""
    return (27 * op.C * op.U + 9 * op.nb * op.U + 12 * op.C * op.U) * itemsize


def rowop_least_bytes(op: RowOp, itemsize: int = 4) -> int:
    """Bytes one K2 launch must move at least: the tables (9 values and
    one int32 column per slot), x read once and y written once."""
    return (op.n_out * op.D * (9 * itemsize + 4)
            + 3 * (op.n_src + op.n_out) * itemsize)


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel by its name."""
    low = name.lower()
    if "phase_round" in low:
        return "k1_phase_round"
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
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("ProfilerStep")):
            out.append((e.name, e.time_range.start, e.time_range.elapsed_us()))
    if not out:
        raise RuntimeError("torch.profiler recorded no device kernel")
    return out


def _busy_us(kernels) -> float:
    """Length of the union of the kernels' intervals."""
    busy, end = 0.0, None
    for _, s, d in sorted(kernels, key=lambda k: k[1]):
        if end is None or s >= end:
            busy, end = busy + d, s + d
        elif s + d > end:
            busy, end = busy + (s + d - end), s + d
    return busy


def _trace(fn, reps: int):
    """Device kernels of reps calls of fn, traced after one untraced
    profiler warm-up step of the same calls (the tracer can miss kernels
    launched just after it starts)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return _kernels(prof)


def _check_launches(kernels, launched: dict):
    """Raise unless the trace holds each kernel class's counted launches."""
    for cls, n in launched.items():
        traced = sum(1 for name, _, _ in kernels if kernel_class(name) == cls)
        if traced != n:
            raise RuntimeError(f"traced {traced} {cls} launches, the wrapper "
                               f"counted {n}")


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


def bench_solver(device) -> semi.SemiSolver:
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.05, ntime=1,
                     n_multigrid=1, coarse_agg=False, coarse_cheb_degree=8,
                     coarse_cheb_lower=0.02, coarse_pack=4)
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


def vcycle_profile(solver: semi.SemiSolver, cycles: int = 20) -> dict:
    b_t = solver._rhs_t(to_t(solver.initial_condition()))
    state = {"x": to_t(solver.initial_condition())}

    def cycle():
        state["x"] = solver._vcycle_t(0, state["x"], b_t)

    for _ in range(3):
        cycle()
    torch.cuda.synchronize()
    wall_ms = event_ms(cycle, cycles)
    n1, n2 = K.KERNEL.launches, K2.KERNEL.launches
    t0 = time.perf_counter()
    for _ in range(cycles):
        cycle()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / cycles
    launched = {"k1_phase_round": K.KERNEL.launches - n1,
                "k2_rowop": K2.KERNEL.launches - n2}
    torch.cuda.synchronize()
    kernels = _trace(cycle, cycles)
    _check_launches(kernels, launched)
    by_class: dict[str, dict] = {}
    for name, _, d in kernels:
        c = by_class.setdefault(kernel_class(name),
                                {"device_us": 0.0, "launches": 0})
        c["device_us"] += d / cycles
        c["launches"] += 1
    for c in by_class.values():
        c["launches"] /= cycles
    busy = _busy_us(kernels)
    span = (max(s + d for _, s, d in kernels)
            - min(s for _, s, _ in kernels))
    return {"cycles": cycles, "by_class": by_class,
            "device_busy_us": busy / cycles,
            "device_span_us": span / cycles,
            "device_idle_share": 1.0 - busy / span,
            "wall_ms_cuda_events": wall_ms,
            "host_enqueue_ms": enqueue_ms}


def round_profile(op: StencilOperator, rounds: int = 80) -> dict:
    """Device time of one K1 round on op, from a phase of ``rounds``
    rounds (coef 0, so the state stays finite)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, op.C, op.U), generator=g).to(op.Fp_t.device)
    bp = torch.randn((3, op.C, op.U), generator=g).to(op.Fp_t.device)
    run = lambda: K.phase(op, x, bp, [0.0] * (rounds - 1), True)
    run()
    torch.cuda.synchronize()
    wall_ms = event_ms(run, 3)
    kernels = [k for k in _trace(run, 1) if "phase_round" in k[0]]
    if len(kernels) != rounds:
        raise RuntimeError(f"traced {len(kernels)} K1 rounds, ran {rounds}")
    dev_us = sum(d for _, _, d in kernels) / rounds
    nbytes = least_bytes(op, x.element_size())
    return {"C": op.C, "U": op.U, "nb": op.nb, "rounds": rounds,
            "device_us_per_round": dev_us,
            "wall_us_per_round": wall_ms * 1e3 / rounds,
            "least_bytes": nbytes,
            "effective_GBps": nbytes / (dev_us * 1e-6) / 1e9}


def rowop_profile(op: RowOp, reps: int = 50) -> dict:
    """Device time of one K2 launch on op."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, op.n_src), generator=g).to(op.vals_t.device)
    run = lambda: op(x)
    run()
    torch.cuda.synchronize()
    kernels = [k for k in _trace(lambda: [run() for _ in range(reps)], 1)
               if "rowop" in k[0]]
    if len(kernels) != reps:
        raise RuntimeError(f"traced {len(kernels)} K2 launches, ran {reps}")
    dev_us = sum(d for _, _, d in kernels) / reps
    nbytes = rowop_least_bytes(op, x.element_size())
    return {"N": op.n_out, "D": op.D, "S": op.n_src,
            "device_us": dev_us, "least_bytes": nbytes,
            "effective_GBps": nbytes / (dev_us * 1e-6) / 1e9}


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device is available")
    dev = torch.device("cuda", 0)
    bench, cli, amg = bench_solver(dev), cli_solver(dev), amg_solver(dev)
    sweep6, deep_amg = sweep_solver(dev, 6), deep_amg_solver(dev)
    out = {"device": torch.cuda.get_device_name(0),
           "vcycle": vcycle_profile(bench), "amg_vcycle": vcycle_profile(amg),
           "sweep6_wcycle": vcycle_profile(sweep6),
           "deep_amg_vcycle": vcycle_profile(deep_amg),
           "rounds": {}, "rowops": {}}
    _print_vcycle("bench-geometric V-cycle", out["vcycle"])
    _print_vcycle("production amg V-cycle", out["amg_vcycle"])
    _print_vcycle("level sweep, 6-level W-cycle", out["sweep6_wcycle"])
    _print_vcycle("level sweep, amg V-cycle", out["deep_amg_vcycle"])
    levels = [(f"bench_L{i}", op) for i, op in enumerate(bench.ops)]
    levels += [(f"cli_L{i}", op) for i, op in enumerate(cli.ops) if op.C > 1]
    levels += [(f"sweep_L{i}", op) for i, op in enumerate(sweep6.ops)
               if op.C > 1]
    print(f"{'level':10s} {'C':>4s} {'U':>5s} {'nb':>3s} {'dev us/round':>13s}"
          f" {'wall us/round':>14s} {'least MB':>9s} {'GB/s':>7s}")
    for name, op in levels:
        r = round_profile(op)
        out["rounds"][name] = r
        print(f"{name:10s} {r['C']:4d} {r['U']:5d} {r['nb']:3d} "
              f"{r['device_us_per_round']:13.2f} "
              f"{r['wall_us_per_round']:14.2f} {r['least_bytes'] / 1e6:9.2f}"
              f" {r['effective_GBps']:7.0f}")
    print(f"{'rowop':12s} {'N':>7s} {'D':>4s} {'S':>7s} {'dev us':>8s}"
          f" {'least MB':>9s} {'GB/s':>7s}")
    for name, op in amg.agg.rowops().items():
        r = rowop_profile(op)
        out["rowops"][name] = r
        print(f"{name:12s} {r['N']:7d} {r['D']:4d} {r['S']:7d} "
              f"{r['device_us']:8.2f} {r['least_bytes'] / 1e6:9.2f} "
              f"{r['effective_GBps']:7.0f}")
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return out


if __name__ == "__main__":
    main()

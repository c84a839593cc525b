"""Device-time profile of the port on one GPU.

    python -m p_a_multigrids_tpu_torch.utils.profiling [--out FILE]

Two measurements, each printed as a table and gathered into one JSON object
(printed last, and written to FILE when given):

- ``vcycle``: where one V-cycle of the bench-geometric configuration
  (``tri_mesh(128, 32, 3/128, 1/128)``, n_split 2, 2 levels, 393,216 DOF)
  spends its device time, by kernel class, with launches per cycle, the
  wall time per cycle by CUDA events, the host's enqueue time per cycle,
  and the device's idle share of the profiled window.
- ``rounds``: the device time of one K1 round at each level K1 runs on in
  the bench-geometric configuration and in the CLI main path
  (``tri_mesh(24, 24, 1/24, 1/24)``, n_split 3, 4 levels), beside the least
  bytes a round must move and the rate that implies.

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
from ..ops.fused import to_t
from ..ops.stencil import StencilOperator


def least_bytes(op: StencilOperator, itemsize: int = 4) -> int:
    """Bytes one K1 round must move at least: the premultiplied face planes
    Fp (27 per child), the slot blocks Xp (9 per slot), and the four state
    planes x, bp, x_out, z (3 per child); index tables not counted."""
    return (27 * op.C * op.U + 9 * op.nb * op.U + 12 * op.C * op.U) * itemsize


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel by its name."""
    low = name.lower()
    if "phase_round" in low:
        return "k1_phase_round"
    if "gemm" in low or "cutlass" in low or "cublas" in low:
        return "gemm"
    if "reduce" in low:
        return "reduction"
    return "elementwise_copy_fill"


def _kernels(prof) -> list:
    """(name, start_us, duration_us) of every device kernel in a trace."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _kernels(prof)


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


def cli_solver(device) -> semi.SemiSolver:
    """The CLI main path's solver (``--rows 24 --cols 24 --n-split 3
    --levels 4``, CLI defaults otherwise)."""
    cfg = SemiConfig(n_split=3, multi_levels=4, ntime=2)
    return semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(24, 24, 1 / 24, 1 / 24), cfg), device)


def vcycle_profile(solver: semi.SemiSolver, cycles: int = 20) -> dict:
    b_t = solver._rhs_t(to_t(solver.initial_condition()))
    state = {"x": to_t(solver.initial_condition())}

    def cycle():
        state["x"] = solver._vcycle_t(0, state["x"], b_t)

    for _ in range(3):
        cycle()
    torch.cuda.synchronize()
    wall_ms = event_ms(cycle, cycles)
    t0 = time.perf_counter()
    for _ in range(cycles):
        cycle()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / cycles
    torch.cuda.synchronize()
    kernels = _trace(cycle, cycles)
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="p_a_multigrids_tpu_torch.utils.profiling")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device is available")
    dev = torch.device("cuda", 0)
    bench, cli = bench_solver(dev), cli_solver(dev)
    out = {"device": torch.cuda.get_device_name(0),
           "vcycle": vcycle_profile(bench), "rounds": {}}
    v = out["vcycle"]
    print(f"bench-geometric V-cycle, {v['cycles']} cycles")
    print(f"{'class':24s} {'device us/cycle':>16s} {'launches/cycle':>15s}")
    for name, c in sorted(v["by_class"].items()):
        print(f"{name:24s} {c['device_us']:16.2f} {c['launches']:15.1f}")
    print(f"device busy {v['device_busy_us']:.2f} us/cycle, span "
          f"{v['device_span_us']:.2f} us/cycle, idle share "
          f"{v['device_idle_share']:.4f}; wall {v['wall_ms_cuda_events']:.4f}"
          f" ms/cycle (CUDA events), host enqueue "
          f"{v['host_enqueue_ms']:.4f} ms/cycle")
    levels = [(f"bench_L{i}", op) for i, op in enumerate(bench.ops)]
    levels += [(f"cli_L{i}", op) for i, op in enumerate(cli.ops) if op.C > 1]
    print(f"{'level':10s} {'C':>3s} {'U':>5s} {'nb':>3s} {'dev us/round':>13s}"
          f" {'wall us/round':>14s} {'least MB':>9s} {'GB/s':>7s}")
    for name, op in levels:
        r = round_profile(op)
        out["rounds"][name] = r
        print(f"{name:10s} {r['C']:3d} {r['U']:5d} {r['nb']:3d} "
              f"{r['device_us_per_round']:13.2f} "
              f"{r['wall_us_per_round']:14.2f} {r['least_bytes'] / 1e6:9.2f}"
              f" {r['effective_GBps']:7.0f}")
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return out


if __name__ == "__main__":
    main()

"""How many of the K1 and K2 launches a torch.profiler trace keeps, by how
the trace is taken, on one GPU; and how many kernels the library call (a
cuSPARSE BSR product) runs a call in such a trace.

    PYTHONPATH=. python scripts/torch_trace_check.py [--reps N] [--out FILE]

Each workload runs REPS times under each way of tracing it (``WAYS``),
in turns:

- ``bare``: the profiler started, the block, the profiler stopped;
- ``margins``: the same with the device synchronised and
  ``utils.profiling.MARGIN_S`` of idle time after the start and before the
  stop;
- ``warm_up``: those margins and an empty warm-up step before recording;
- ``prime64``, ``prime512``: as ``warm_up``, with 64 or 512 one-element
  fills launched and finished before the block;
- ``spin20ms``: as ``warm_up``, with a 20 ms spin kernel before the block;
- ``sleep50ms``: as ``warm_up``, with 50 ms of idle time before the block;
- ``trace``: ``utils.profiling.trace`` (as ``prime512``).

The workloads: the small production amg CLI (``--mode 9 --rows 8 --cols 8
--levels 1 --amg --krylov``) in float64 and in float32 (its kernels start
about a millisecond after the trace does), and 5 production amg V-cycles
at 393,216 DOF launched at once (``utils.profiling.amg_solver``).  Each
run's traced K1 and K2 kernels are counted against the wrappers' counts.
Each trace's launch calls are matched to its kernels (``launch_gaps``):
the calls that have no kernel, and the time from a call to its kernel.
Then LIB_CALLS calls of ``bsr_matrix(l0_op) @ x`` on that solver's
finest SA rowop are traced by ``utils.profiling.trace``, TRIES times,
their kernels counted by name and their device time summed.  Prints one JSON object (and writes it to
FILE); exits 1 when ``trace`` lost a launch.
"""

import argparse
import collections
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from p_a_multigrids_tpu_torch import __main__ as cli
from p_a_multigrids_tpu_torch import bench
from p_a_multigrids_tpu_torch.ops import phase as K
from p_a_multigrids_tpu_torch.ops import spmv as K2
from p_a_multigrids_tpu_torch.ops.fused import to_t
from p_a_multigrids_tpu_torch.utils import profiling

CLI_ARGS = ["--mode", "9", "--rows", "8", "--cols", "8", "--levels", "1",
            "--amg", "--krylov", "--device", "cuda"]
CYCLES = 5
LIB_CALLS = 20
TRIES = 3
# clock rate torch.cuda._sleep counts in (the H100 SXM's boost clock)
SPIN_HZ = 1.98e9


@contextlib.contextmanager
def _way(path, warm_up=False, margins=False, prime=0, spin_ms=0.0,
         sleep_s=0.0):
    """A torch.profiler trace of the block: started at once or after an
    empty warm-up step, with ``margins`` (the device synchronised and idle
    MARGIN_S at both ends), and before the block ``prime`` one-element
    fills, a spin kernel of ``spin_ms`` and ``sleep_s`` of idle time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, schedule=(
        torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        if warm_up else None))
    prof.start()
    if warm_up:
        _idle()
        prof.step()
    if margins:
        _idle()
    one = torch.zeros(1, device="cuda")
    for _ in range(prime):
        one.fill_(1.0)
    if spin_ms:
        torch.cuda._sleep(int(spin_ms * 1e-3 * SPIN_HZ))
    torch.cuda.synchronize()
    time.sleep(sleep_s)
    try:
        yield path
    finally:
        if margins:
            _idle()
        prof.stop()
        prof.export_chrome_trace(path)


def _idle():
    torch.cuda.synchronize()
    time.sleep(profiling.MARGIN_S)


def _trace(path):
    return profiling.trace(os.path.dirname(path))


WAYS = {"bare": lambda p: _way(p),
        "margins": lambda p: _way(p, margins=True),
        "warm_up": lambda p: _way(p, warm_up=True, margins=True),
        "prime64": lambda p: _way(p, True, True, prime=64),
        "prime512": lambda p: _way(p, True, True, prime=512),
        "spin20ms": lambda p: _way(p, True, True, spin_ms=20.0),
        "sleep50ms": lambda p: _way(p, True, True, sleep_s=0.05),
        "trace": _trace}


def _counts() -> dict:
    return {"k1_phase": K.KERNEL.launches, "k2_rowop": K2.KERNEL.launches}


def launch_gaps(path) -> dict:
    """The kernel launch calls of a Chrome trace matched to the kernels by
    correlation id: us from each call to its kernel's start (min, max),
    and for each call with no kernel, its place among the calls and us
    from its time to the end of the last event of the trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls = sorted((e for e in events
                    if e.get("cat", "").startswith("cuda_")
                    and "Launch" in e.get("name", "")),
                   key=lambda e: e["ts"])
    starts = {e["args"].get("correlation"): e["ts"] for e in events
              if e.get("cat") == "kernel"}
    end = max(e["ts"] + e.get("dur", 0) for e in events if "ts" in e)
    gaps = [starts[c["args"]["correlation"]] - c["ts"] for c in calls
            if c["args"].get("correlation") in starts]
    lost = [{"call": i, "of": len(calls), "name": c["name"],
             "us_to_end": end - c["ts"]}
            for i, c in enumerate(calls)
            if c["args"].get("correlation") not in starts]
    return {"call_to_kernel_us": [min(gaps), max(gaps)] if gaps else None,
            "lost": lost}


def traced_run(way, block, tmp) -> dict:
    """Counted and traced K1 / K2 launches of one traced block, with its
    launch_gaps."""
    path = os.path.join(tmp, "trace.json")
    before = _counts()
    with WAYS[way](path):
        block()
    counted = {k: v - before[k] for k, v in _counts().items()}
    kernels = profiling.trace_kernels(path)
    traced = {k: sum(profiling.kernel_class(n) == k for n, _, _ in kernels)
              for k in counted}
    return {"counted": counted, "traced": traced, **launch_gaps(path)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_trace_check: needs a CUDA device")
    dev = torch.device("cuda", 0)
    K.KERNEL.function(torch.float32)
    K2.KERNEL.function(torch.float32)
    sv = profiling.amg_solver(dev)
    x_t = to_t(sv.initial_condition())
    b_t = sv._rhs_t(x_t)

    def cycles():
        x = x_t
        for _ in range(CYCLES):
            x = sv._vcycle_t(0, x, b_t)

    blocks = {"cli_f64": lambda: cli.run(CLI_ARGS + ["--f64"]),
              "cli_f32": lambda: cli.run(CLI_ARGS),
              "amg_cycles": cycles}
    for block in blocks.values():                 # builds, first calls
        block()
    torch.cuda.synchronize()
    runs = collections.defaultdict(list)
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(args.reps):
            for name, block in blocks.items():
                for way in WAYS:
                    runs[f"{name}.{way}"].append(traced_run(way, block, tmp))
        op = sv.agg.rowops()["l0_op"]
        M = profiling.bsr_matrix(op)
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=3 * op.n_src).astype(np.float32), device=dev)
        M @ x
        library = []
        for _ in range(TRIES):
            with profiling.trace(tmp) as path:
                for _ in range(LIB_CALLS):
                    M @ x
            ks = profiling.trace_kernels(path)
            library.append({
                "kernels": dict(collections.Counter(n for n, _, _ in ks)),
                "device_us_a_call": sum(d for _, _, d in ks) / LIB_CALLS})
    summary = {}
    for key, rs in runs.items():
        short = [r for r in rs if r["traced"] != r["counted"]]
        gaps = [r["call_to_kernel_us"] for r in rs if r["call_to_kernel_us"]]
        summary[key] = {"runs": len(rs), "short": len(short),
                        "counted": rs[0]["counted"],
                        "traced_when_short": [r["traced"] for r in short],
                        "lost": [r["lost"] for r in rs if r["lost"]],
                        "call_to_kernel_us": [min(g[0] for g in gaps),
                                              max(g[1] for g in gaps)]
                        if gaps else None}
    out = {"device": bench._device_name(dev), "reps": args.reps,
           "margin_s": profiling.MARGIN_S, "ways": summary,
           "library": {"calls": LIB_CALLS, "tries": library}}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    lost = any(v["short"] for k, v in summary.items()
               if k.endswith(".trace"))
    return 1 if lost else 0


if __name__ == "__main__":
    sys.exit(main())

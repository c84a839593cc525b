"""The benchmark's frozen yardstick: the card's peak, the least bytes of
the kernels' calls, and the reading of a torch.profiler trace.

Each function is a copy of the program's own (``p_a_multigrids_tpu_torch``
at the commit that added this benchmark), named beside it, so that a later
change to the program cannot move what the benchmark measures with.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

# device memory rate of an H100 SXM, NVIDIA's data sheet, at 700 W
# (copy of utils/profiling.HBM_BYTES_PER_S)
HBM_BYTES_PER_S = 3.35e12

# one-element int8 fills that open every traced window: a trace taken in a
# process that had used the card for minutes lost its first 19-42 kernels
# unless it opened with such fills (copy of utils/profiling.TRACE_PRIME,
# PRIME_KERNEL, _prime); nothing else fills an int8 tensor, so their
# kernels are known by name and left out
TRACE_PRIME = 512
PRIME_KERNEL = "FillFunctor<signed char>"
# host idle time at both ends of a traced window (utils/profiling.MARGIN_S)
MARGIN_S = 0.002


def least_bytes(C: int, U: int, itemsize: int, planes: int) -> int:
    """Bytes one relaxation-phase call (kernel K1) on a (3, C, U) level
    must move at least: 27 premultiplied coupling values a child and
    ``planes`` state planes of 3 values a child (a phase reads x0 and bp
    and writes x, and z when asked for it; the zero-round apply reads x
    and writes z).  Copy of utils/profiling.least_bytes."""
    return (27 + 3 * planes) * C * U * itemsize


def phase_planes(coefs, want_z: bool) -> int:
    """State planes a phase call must move: 2 for the zero-round apply,
    else x0, bp and x, and z when it is asked for."""
    if not len(coefs):
        return 2
    return 3 + int(bool(want_z))


def rowop_least_bytes(op, itemsize: int) -> int:
    """Bytes one block-row SpMV call (kernel K2) must move at least: the
    tables' nonzero slots (9 values and one int32 column each), x read
    once and y written once.  Copy of utils/profiling.rowop_least_bytes;
    reads ``op.tables()`` (it syncs with the card: call it before a
    window)."""
    vals = op.tables()[1]                                 # (D, 3, 3, N)
    slots = int((vals != 0).flatten(1, 2).any(1).sum())
    return (slots * (9 * itemsize + 4)
            + 3 * (op.n_src + op.n_out) * itemsize)


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel by its name (copy of
    utils/profiling.kernel_class)."""
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


def prime():
    """TRACE_PRIME one-element int8 fills on the current card, finished
    before this returns (utils/profiling._prime)."""
    one = torch.empty(1, dtype=torch.int8,
                      device=torch.cuda.current_device())
    for _ in range(TRACE_PRIME):
        one.fill_(1)
    torch.cuda.synchronize()


def busy_us(intervals) -> float:
    """Length of the union of (start, duration) intervals
    (utils/profiling._busy_us)."""
    busy, end = 0.0, None
    for s, d in sorted(intervals):
        if end is None or s >= end:
            busy, end = busy + d, s + d
        elif s + d > end:
            busy, end = busy + (s + d - end), s + d
    return busy


def idle_gaps(intervals):
    """(start, length) of every gap between the union's pieces."""
    gaps, end = [], None
    for s, d in sorted(intervals):
        if end is not None and s > end:
            gaps.append((end, s - end))
        end = s + d if end is None else max(end, s + d)
    return gaps


def trace_window(fn, launch_counts, cuda: bool = True):
    """Run fn() under torch.profiler (CPU and, with ``cuda``, CUDA
    activities) after the priming fills, with MARGIN_S of idle host time
    at both ends, and return (events, launched): the Chrome trace's events
    and the change of ``launch_counts()`` (kernel class -> the program's
    own launch count) over fn."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            if cuda:
                prime()
            before = launch_counts()
            time.sleep(MARGIN_S)
            fn()
            if cuda:
                torch.cuda.synchronize()
            time.sleep(MARGIN_S)
            launched = {k: v - before[k] for k, v in launch_counts().items()}
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return events, launched


def read_window(events, span_names):
    """The kernels of one traced window, each with the spans (record
    ranges named in ``span_names``) its launch lies in, and the host
    events that idle gaps are named by.

    Returns (kernels, host): kernels a list of dicts {"name", "ts", "dur",
    "cls", "spans"} (microseconds, the priming fills left out), host a
    list of (ts, dur, name) of the CPU ops and record ranges."""
    launch_ts = {}
    spans = {n: [] for n in span_names}
    host = []
    for e in events:
        cat = e.get("cat")
        if cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
        elif cat == "user_annotation":
            if e["name"] in spans:
                spans[e["name"]].append((float(e["ts"]), float(e["dur"])))
            host.append((float(e["ts"]), float(e["dur"]), e["name"]))
        elif cat == "cpu_op":
            host.append((float(e["ts"]), float(e["dur"]), e["name"]))
    bounds = {}
    for n, iv in spans.items():
        iv.sort()
        bounds[n] = (np.array([s for s, _ in iv]),
                     np.array([s + d for s, d in iv]))
    kernels = []
    for e in events:
        if e.get("cat") != "kernel" or PRIME_KERNEL in e["name"]:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        inside = set()
        if t is not None:
            for n, (starts, ends) in bounds.items():
                i = np.searchsorted(starts, t, side="right") - 1
                if i >= 0 and t <= ends[i]:
                    inside.add(n)
        kernels.append({"name": e["name"], "ts": float(e["ts"]),
                        "dur": float(e["dur"]),
                        "cls": kernel_class(e["name"]), "spans": inside})
    return kernels, host


def missing_launches(kernels, launched: dict) -> str | None:
    """What the window's trace lacks of each kernel class's counted
    launches, or None when it holds them all
    (utils/profiling._missing_launches)."""
    for cls, n in launched.items():
        traced = sum(1 for k in kernels if k["cls"] == cls)
        if traced != n:
            return f"traced {traced} {cls} launches, the program counted {n}"
    return None


def name_gaps(host, gaps) -> list:
    """What the host was doing in the middle of each (start, length) gap:
    the innermost (shortest) CPU op or record range around that time, or
    "python" outside every one."""
    if not host:
        return ["python"] * len(gaps)
    starts = np.array([s for s, _, _ in host])
    durs = np.array([d for _, d, _ in host])
    names = []
    for s, d in gaps:
        t = s + 0.5 * d
        around = (starts <= t) & (starts + durs >= t)
        if not around.any():
            names.append("python")
            continue
        i = np.flatnonzero(around)[np.argmin(durs[around])]
        names.append(host[i][2])
    return names

"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 -m pamg_bench.run --workload W --seed N --seconds S --trace 0|1

From the root of a checkout.  A run builds the cell's solver through the
port's public constructors, makes the mix's initial states on the card
from the seed, warms up on the cell's own shapes (the first run in a
checkout builds the kernels there, into the port's ``_build/``), then
steps as the CLI's time loop does, one time step at a time: ``S =
st.step(S)`` and the residual read on the host, ``float(st.convergence(
S))``, restarting from the next initial state every ``episode_steps``
steps.  Without a trace it steps for ``--seconds`` and reports the
end-to-end metrics; with one it steps through the mix's traced windows
and reports the per-layer metrics.  Then it frees the solver and holds a
seeded sample of the steps' states against the plain reference
(``reference/``) for ``correct``.

Prints one JSON line on stdout, and the compared numbers beside their
limits as the last lines on stderr.  Exits 2 without a result where
there is no card or fewer than the cell asks for, and 1 where the JAX
package or JAX was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import spec, system, traffic, yardstick  # noqa: E402
from .reference import check as ref_check  # noqa: E402
from .reference import dg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names the port must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "p_a_multigrids_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Traffic:
    """The mix's steps: which state each step starts from, and a seeded
    reservoir sample of (input, output) states, copied into buffers made
    in set-up."""

    def __init__(self, cell, solver, seed: int, device):
        mix = cell.traffic
        st = solver.stepper()
        coords = dg.child_coords(
            dg.structured_macro_X(*cell.config["mesh"]["tri_mesh"]),
            cell.config["semi"]["n_split"])
        ics = traffic.initial_states(coords, mix, seed, device,
                                     solver.dtype)
        self.starts = [st.to_state(ic) for ic in ics]
        self.order = traffic.episode_order(seed, len(self.starts), device)
        self.episode = int(mix["episode_steps"])
        k = int(mix["sample"])
        like = self.starts[0]
        self.buf_in = [torch.empty_like(like) for _ in range(k)]
        self.buf_out = [torch.empty_like(like) for _ in range(k)]
        self.filled = 0
        self.rng = random.Random(seed)
        self.i = 0

    def start(self, S):
        """The state step i starts from: S, or the next initial state."""
        if self.i % self.episode == 0:
            e = self.i // self.episode
            return self.starts[self.order[e % len(self.order)]]
        return S

    def slot(self):
        """The sample slot step i takes, or None (reservoir sampling)."""
        k = len(self.buf_in)
        if self.i < k:
            return self.i
        j = self.rng.randrange(self.i + 1)
        return j if j < k else None

    def restart(self):
        """Start the sequence again, with an empty sample."""
        self.i = 0
        self.filled = 0

    def sample(self, from_state):
        """The sampled (input, output) pairs as flat float64 arrays in the
        (U, C, 3) layout."""
        n = min(self.filled, len(self.buf_in))
        return [tuple(from_state(b).double().cpu().numpy().reshape(-1)
                      for b in (self.buf_in[j], self.buf_out[j]))
                for j in range(n)]


def run_steps(st, tr: Traffic, rec, S, n: int | None, until: float | None,
              times: list, residuals: list):
    """Steps from S, n of them or until the host clock passes ``until``,
    each one traffic step: st.step, then the residual read on the host.
    Returns the last state."""
    taken = 0
    while True:
        S = tr.start(S)
        j = tr.slot()
        if j is not None:
            tr.buf_in[j].copy_(S)
        t0 = time.perf_counter()
        with rec.span("step"):
            S = st.step(S)
            res = float(st.convergence(S))
        t1 = time.perf_counter()
        if j is not None:
            tr.buf_out[j].copy_(S)
            tr.filled += 1
        tr.i += 1
        times.append((t0, t1))
        residuals.append(res)
        taken += 1
        if (n is not None and taken >= n) or (
                until is not None and t1 >= until):
            return S


def judge(cell, pairs) -> dict:
    """The compared numbers of the cell's check, each {"value",
    "limit"}."""
    X = dg.structured_macro_X(*cell.config["mesh"]["tri_mesh"])
    check = ref_check.CHECKS[cell.traffic["check"]](X, cell.semi_fields())
    value = ref_check.worst(check, pairs) if pairs else float("inf")
    return {check.name: {"value": value,
                         "limit": float(cell.limits[check.name])}}


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = ROOT, pkg: Path = spec.PKG,
             t0: float = _T0) -> dict:
    """One run of ``workload``; returns the result line as a dict (with
    the compared numbers under "compared", last)."""
    device = torch.device(device)
    cell = spec.load_cell(root, workload, trace, pkg)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    solver = system.build(cell, device)
    st = solver.stepper()
    tr = Traffic(cell, solver, seed, device)
    rec = system.Recorder(spans=trace)
    record: dict = {"krylov": bool(cell.semi_fields().get("krylov"))}
    with rec:
        if trace:
            rec.count_rowops(solver)
        # warm-up: the cell's own shapes, through the same calls
        S = run_steps(st, tr, rec, None, int(cell.traffic["warmup_steps"]),
                      None, [], [])
        if cuda:
            torch.cuda.synchronize(device)
        record["setup_s"] = time.perf_counter() - t0
        tr.restart()
        rec.reset()
        times, residuals = [], []
        its0 = len(solver.krylov_iters)
        if trace:
            S = traced_windows(cell, solver, tr, rec, S, times,
                               residuals, record)
        else:
            S = run_steps(st, tr, rec, S, None,
                          time.perf_counter() + seconds, times, residuals)
        if cuda:
            torch.cuda.synchronize(device)
        failed = rec.failed_steps(residuals)
    record["window_s"] = times[-1][1] - times[0][0]
    record["step_s"] = [b - a for a, b in times]
    record["steps"] = len(times)
    record.setdefault("krylov_its", sum(solver.krylov_iters[its0:]))
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    dev = device_info(device)
    record["memory_peak_bytes"] = dev["memory_peak_bytes"]
    pairs = tr.sample(st.from_state)
    del solver, st, tr, S
    if cuda:
        torch.cuda.empty_cache()
    compared = judge(cell, pairs)
    metrics = {}
    for name, unit, mod in cell.metrics:
        value = mod.read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    out = {"correct": bool(correct), "attempted": len(times),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        out["device"]["busy_s"] = record["busy_us"] * 1e-6
        out["device"]["window_s"] = record["span_us"] * 1e-6
        out["breakdown"] = record["breakdown"]
    out["compared"] = compared
    return out


def traced_windows(cell, solver, tr, rec, S, times, residuals, record):
    """The mix's traced windows of at most 5 steps each, every one opened
    with the priming fills; a window whose trace lacks a K1 or K2 launch
    the program counted is traced again (5 tries), and its steps are not
    counted.  Fills ``record`` with the kernels, their spans, the Krylov
    iterations and the host's idle gaps."""
    st = solver.stepper()
    cuda = solver.device.type == "cuda"
    n_win = int(cell.traffic["trace_windows"])
    w_steps = int(cell.traffic["trace_window_steps"])
    kernels, busy, span, gaps, its = [], 0.0, 0.0, {}, 0
    state = {"S": S}
    for _ in range(n_win):
        for _ in range(5):
            mark = (len(times), len(rec.solves), len(solver.krylov_iters),
                    rec.calls.copy(), rec.bytes.copy())

            def window():
                state["S"] = run_steps(st, tr, rec, state["S"], w_steps,
                                       None, times, residuals)

            events, launched = yardstick.trace_window(
                window, system.launch_counts, cuda)
            ks, host = yardstick.read_window(events, system.SPANS)
            missing = (yardstick.missing_launches(ks, launched)
                       if ks or not cuda else "no device kernel traced")
            if missing is None:
                break
            del times[mark[0]:], residuals[mark[0]:], rec.solves[mark[1]:]
            rec.calls, rec.bytes = mark[3], mark[4]
        else:
            raise RuntimeError(f"traced window: {missing}")
        its += sum(solver.krylov_iters[mark[2]:])
        iv = [(k["ts"], k["dur"]) for k in ks]
        busy += yardstick.busy_us(iv)
        if iv:
            span += max(s + d for s, d in iv) - min(s for s, _ in iv)
        g = yardstick.idle_gaps(iv)
        for name, (_, length) in zip(yardstick.name_gaps(host, g), g):
            gaps[name] = gaps.get(name, 0.0) + length
        kernels += ks
    by_name: dict = {}
    for k in kernels:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"]

    def top(d):
        return [[n, v * 1e-6] for n, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:10]]

    record.update(kernels=kernels, busy_us=busy, span_us=span,
                  krylov_its=its, calls=rec.calls.copy(),
                  least_bytes=rec.bytes.copy(),
                  breakdown={"device_ops": top(by_name),
                             "idle_gaps": top(gaps)})
    return state["S"]


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(ROOT, args.workload, bool(args.trace))
    if not torch.cuda.is_available():
        print("pamg_bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"pamg_bench: {cell.chips} cards asked for, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except ForbiddenImport as e:
        print(f"pamg_bench: loaded {', '.join(e.args[0])}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"pamg_bench: loaded {', '.join(found)}", file=sys.stderr)
        return 1
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

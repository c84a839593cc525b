"""Distributed benchmark of the port: the sharded solver against its serial
twin, on N ranks.

    python -m p_a_multigrids_tpu_torch.bench_dist [--devices N]
        [--section retention|dist8|overhead] [--device cuda|cpu]
        [--model-at M] [--out PATH]

The counterpart of the JAX system's three distributed measurement
programs, one section each:

- ``retention`` (``scripts/bench_dist_tpu.py``), at N = 1: geometric and
  production amg on the RCM-reordered bench mesh, ms a level-0 cycle of
  the distributed solver against its serial twin (``retention_factor``),
  with ``ghost_model_at_D{M}``: the ghost report the solver would give on
  M ranks (``parallel.stencil_solver.ghost_model_at``, the solver's own
  ``ghost_plan``);
- ``dist8`` (``scripts/bench_dist8.py``), at N >= 2: the production amg
  configuration chunked (``dist_ghost_max_frac`` 0.25) and as one deep
  ghost chunk (1e9), the same on a (2, N/2) mesh shape (N even, N >= 4)
  and geometric: ms a cycle against the serial twin, the ghost report,
  the per-rank work fraction and the ideal speedup at N;
- ``overhead`` (``scripts/bench_distributed.py``), at N >= 2: a whole time
  step of the serial twin (RCM-ordered, padded to N) against the
  distributed step, and the halo window W.

Without ``--section`` every section the world allows runs.  The ranks are
one process each (``parallel.comm.launch``, ``parallel.programs.
bench_dist_rank``): ``--devices`` defaults to the visible cards, one rank a
card under nccl; more ranks than cards share them under gloo (messages
staged through host memory: ``ranks_per_card`` > 1 measures the host and
the staging, not scaling).  With ``--device cpu`` the default is one rank.
Every window is eager, between barriers on every rank, timed by CUDA
events on rank 0 after one untimed call; best of ``REPS`` windows.

What differs from the JAX scripts:

- the meshes are generated stand-ins (``DIST8_MESH`` for untitled8192.msh,
  ``OVERHEAD_MESH`` for 900_ele.msh), which ``extra.stand_in_for`` names;
- the cycles run with the twin's right-hand side of T0, not b := x, so
  each configuration also reports ``dist_vs_serial_rel``: the largest
  distance between the gathered distributed state and the twin's after
  the same calls from T0, relative to the twin's largest value;
- the TPU names become the port's: ``kernels`` (was ``pallas``),
  ``k1_phase_dist`` (was ``pallas_phase_dist``: K1 ran the distributed
  phases), ``backend`` the torch.distributed backend; a key named after
  D = 8 carries the run's N (``ideal_speedup_at_D{N}``) or M;
- ``ghost_report`` and ``ghost_model_at`` count the last chunk's rounds
  as ``R - chunk ((R - 1) // chunk)``, not ``chunk``;
- each configuration adds its K1 and K2 launches on every rank over the
  timed windows, rank 0's staging and wait shares of them, and
  ``setup_s`` includes each rank's build of the serial twin;
- a section that raises leaves ``{"error": ...}`` in its place and its
  message in ``errors``, the line is still printed, and the process exits
  1; nothing falls back (no gloo when nccl fails, no serial path).

Prints ONE JSON line on stdout, progress marks on stderr, and writes a
file only at ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from . import bench
from .parallel import comm, programs

# the stand-in for untitled8192.msh (bench.py's, 393,216 DOF at n_split 2)
DIST8_MESH = bench.BENCH_MESH
# the stand-in for 900_ele.msh: 800 macros, 153,600 DOF at n_split 3
OVERHEAD_MESH = (20, 20, 1 / 20, 1 / 20)
# the JAX scripts' configurations (SemiConfig fields)
BASE = dict(dt=0.05, ntime=1, n_multigrid=1, dtype="float32")
PRODUCTION = dict(n_split=2, multi_levels=1, amg=True, agg_strength=0.5,
                  cheb_degree=16, cheb_lower=0.05)
GEOMETRIC = dict(n_split=2, multi_levels=2, coarse_agg=False)
OVERHEAD = dict(n_split=3, multi_levels=2)
# dist8's runs: name, configuration, on the (2, N/2) mesh shape, ghost cap
DIST8_RUNS = (("production_amg", PRODUCTION, False, 0.25),
              ("production_amg_deepghost", PRODUCTION, False, 1e9),
              ("production_amg_2d_mesh", PRODUCTION, True, 0.25),
              ("geometric", GEOMETRIC, False, 0.25))
RETENTION_RUNS = (("geometric", GEOMETRIC), ("production_amg", PRODUCTION))
# calls a timed window (the JAX scripts': 3 cycles, 50 cycles, 20 steps)
# and windows a measurement
DIST8_CYCLES = 3
RETENTION_CYCLES = 50
OVERHEAD_STEPS = 20
REPS = 3
# seconds: the whole pool, and any one collective (rank 0 times the
# serial twin while the others wait at a barrier)
TIMEOUT_S = 3000
PG_TIMEOUT_S = 600
SECTIONS = ("retention", "dist8", "overhead")
NOTE = ("one card a rank under nccl; ranks sharing a card (gloo, staged "
        "through host memory) measure the host and the staging, not "
        "scaling")

_T0 = time.time()


def _mark(msg: str) -> None:
    print(f"[bench_dist +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _message(e: Exception) -> str:
    """An error for the JSON line: its first line and, for a rank's
    traceback, its last."""
    lines = [ln for ln in str(e).strip().splitlines() if ln.strip()]
    text = " ... ".join(lines[:1] + lines[-1:] if len(lines) > 1 else lines)
    return f"{type(e).__name__}: {text}"[:400]


def allowed(section: str, n: int) -> bool:
    """Whether ``section`` runs on a world of n ranks."""
    return n == 1 if section == "retention" else n >= 2


def _launch(runs: list, n: int, device: str) -> list:
    """Every rank's results of ``runs`` (``programs.bench_dist_rank``)."""
    threads = max(1, (os.cpu_count() or 1) // n)
    return comm.launch(programs.bench_dist_rank, n, device,
                       args=({"runs": runs},), timeout=TIMEOUT_S,
                       pg_timeout=PG_TIMEOUT_S, threads=threads)


def _ranks(res: list, i: int) -> dict:
    """Run i's rank 0 result, with every rank's launches and SA rows and
    the slowest rank's setup seconds."""
    r0 = dict(res[0][i])
    r0["setup_s"] = max(r[i]["setup_s"] for r in res)
    r0["launches"] = {k: [r[i]["launches"][k] for r in res]
                      for k in r0["launches"]}
    r0["sa_rows"] = [r[i]["sa_rows"] for r in res]
    return r0


def work_fraction(report: list, U: int) -> float:
    """The share of the serial rows a rank relaxes a round, with its ghost
    rows (``bench_dist8.py``'s aggregate-work model): the mean over levels
    of (1 + redundant_frac) U_loc / U."""
    return float(np.mean([(1.0 + g["redundant_frac"]) * g["U_loc"] / U
                          for g in report]))


def _shared(r: dict, unit: str) -> dict:
    """The keys every configuration of every section adds."""
    return {"dist_vs_serial_rel": r["dist_vs_serial_rel"],
            "launches": r["launches"], "sa_rows": r["sa_rows"],
            "staging_share": r["staging_share"],
            "wait_share": r["wait_share"],
            f"messages_per_{unit}": r["messages"] / r["calls"],
            f"bytes_per_{unit}": r["bytes"] / r["calls"]}


def _cfg(kw: dict, frac: float = 0.25) -> dict:
    return {**BASE, **kw, "dist_ghost_max_frac": frac}


def dist8(n: int, device: str) -> dict:
    """``scripts/bench_dist8.py``'s section on n ranks."""
    runs, left_out = [], {}
    for name, kw, two_d, frac in DIST8_RUNS:
        if two_d and not (n >= 4 and n % 2 == 0):
            left_out[name] = (f"the (2, N/2) mesh shape needs an even N >= "
                              f"4; N = {n}")
            continue
        runs.append(dict(name=name, mesh=DIST8_MESH, cfg=_cfg(kw, frac),
                         mesh_shape=(2, n // 2) if two_d else None,
                         unit="cycle", n=DIST8_CYCLES, reps=REPS))
    res = _launch(runs, n, device)
    configs = {}
    for i, run in enumerate(runs):
        r = _ranks(res, i)
        r["calls"] = run["n"] * run["reps"]
        work = work_fraction(r["ghost_report"], r["U"])
        configs[run["name"]] = {
            "setup_s": r["setup_s"],
            "serial_ms_per_cycle": r["serial_s"] * 1e3,
            "dist_ms_per_cycle": r["dist_s"] * 1e3,
            "dist_over_serial": r["dist_s"] / r["serial_s"],
            "per_chip_work_fraction": work,
            f"ideal_speedup_at_D{n}": 1.0 / work,
            "mesh_shape": list(run["mesh_shape"] or [n]),
            "ghost_report": r["ghost_report"],
            "amg_dist_engaged": r["amg_dist_engaged"],
            **_shared(r, "cycle")}
        _mark(f"dist8 {run['name']} done")
    return {"n_devices": n, "backend": comm.backend_for(device, n),
            "kernels": _kernels(device), "note": NOTE, "configs": configs,
            "left_out": left_out}


def retention(n: int, device: str, model_at: int) -> dict:
    """``scripts/bench_dist_tpu.py``'s section (n = 1)."""
    runs = [dict(name=name, mesh=DIST8_MESH, rcm=True, cfg=_cfg(kw),
                 unit="cycle", n=RETENTION_CYCLES, reps=REPS,
                 model_at=model_at) for name, kw in RETENTION_RUNS]
    res = _launch(runs, n, device)
    configs = {}
    for i, run in enumerate(runs):
        r = _ranks(res, i)
        r["calls"] = run["n"] * run["reps"]
        configs[run["name"]] = {
            "setup_s": r["setup_s"],
            "serial_ms_per_cycle": r["serial_s"] * 1e3,
            "dist_ms_per_cycle": r["dist_s"] * 1e3,
            "retention_factor": r["dist_s"] / r["serial_s"],
            # K1 ran the distributed phases on every rank
            "k1_phase_dist": min(r["launches"]["k1_phase"]) > 0,
            "amg_tables_built": r["amg_tables_built"],
            # at one rank the ghost zones are empty and the SA correction
            # is the serial one: retention measures the machinery around
            # the serial path, not the exchanges
            "d1_serial_agg_shortcircuit": n == 1,
            "d1_ghost_zones_empty": all(g["He"] == 0
                                        for g in r["ghost_report"]),
            f"ghost_model_at_D{model_at}": r["ghost_model"],
            **_shared(r, "cycle")}
        _mark(f"retention {run['name']} done")
    return {"n_devices": n, "backend": comm.backend_for(device, n),
            "kernels": _kernels(device), "configs": configs}


def overhead(n: int, device: str) -> dict:
    """``scripts/bench_distributed.py``'s section on n ranks."""
    run = dict(name="overhead", mesh=OVERHEAD_MESH, cfg=_cfg(OVERHEAD),
               unit="step", n=OVERHEAD_STEPS, reps=REPS)
    r = _ranks(_launch([run], n, device), 0)
    r["calls"] = run["n"] * run["reps"]
    C = r["children"]
    _mark("overhead done")
    return {"mesh": f"tri_mesh{OVERHEAD_MESH}", "n_macro": r["U"],
            "children": C, "ndof": r["U"] * C * 3, "devices": n,
            "backend": comm.backend_for(device, n),
            "setup_s": r["setup_s"],
            "serial_ms_per_step": r["serial_s"] * 1e3,
            "distributed_ms_per_step": r["dist_s"] * 1e3,
            "overhead_factor": r["dist_s"] / r["serial_s"],
            "halo_window_W": r["halo_window_W"],
            "ghost_report": r["ghost_report"],
            "amg_dist_engaged": r["amg_dist_engaged"], "note": NOTE,
            **_shared(r, "step")}


def _kernels(device: str) -> str:
    return ("cuda: K1 csrc/phase.cu, K2 csrc/spmv.cu" if device == "cuda"
            else "plain PyTorch (CPU)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="p_a_multigrids_tpu_torch.bench_dist")
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="ranks (default: the visible cards; 1 on the CPU)")
    ap.add_argument("--section", choices=SECTIONS,
                    help="one section (default: every section the world "
                         "allows: retention at N = 1, dist8 and overhead "
                         "at N >= 2)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model-at", type=int, default=8, metavar="M",
                    help="retention's ghost model: the report at M ranks")
    ap.add_argument("--out", metavar="PATH",
                    help="also write the JSON line to PATH")
    return ap


def main(argv=None) -> int:
    """Run the sections, print the JSON line; 0, or 1 when a section
    failed."""
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_dist: no CUDA device (--device cpu runs on "
                         "the CPU)")
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    n = args.devices or max(cards, 1)
    if n < 1 or args.model_at < 1:
        raise SystemExit("bench_dist: --devices and --model-at take N >= 1")
    if args.out and os.path.basename(args.out).startswith("DIST_BENCH"):
        raise SystemExit("bench_dist: DIST_BENCH*.json are the JAX "
                         "system's records; choose another --out")
    sections = [args.section] if args.section else [
        s for s in SECTIONS if allowed(s, n)]
    bad = [s for s in sections if not allowed(s, n)]
    if bad:
        raise SystemExit(f"bench_dist: {bad[0]} runs at "
                         f"{'N = 1' if bad[0] == 'retention' else 'N >= 2'}"
                         f" ranks, not {n}")
    backend = comm.backend_for(args.device, n)
    used = range(min(n, cards)) if cards else [None]
    result = {
        "devices": n, "backend": backend,
        "ranks_per_card": math.ceil(n / cards) if cards else None,
        "device": [bench._device_name(torch.device("cpu") if i is None
                                      else torch.device("cuda", i))
                   for i in used],
        "extra": {"stand_in_for": {
            "untitled8192.msh": f"tri_mesh{DIST8_MESH}, n_split 2",
            "900_ele.msh": f"tri_mesh{OVERHEAD_MESH}, n_split 3"}},
        "errors": {}}
    _mark(f"{n} ranks, {backend}, sections {sections}")
    run = {"retention": lambda: retention(n, args.device, args.model_at),
           "dist8": lambda: dist8(n, args.device),
           "overhead": lambda: overhead(n, args.device)}
    for name in sections:
        try:
            result[name] = run[name]()
        except Exception as e:
            result["errors"][name] = _message(e)
            result[name] = {"error": result["errors"][name]}
            _mark(f"{name} failed: {result['errors'][name]}")
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 1 if result["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())

"""The production amg knob sweep of the port on one GPU: ms a cycle, rho,
ms to a 1e6 drop, PCG to 1e-6 and setup seconds for seven smoothed
aggregation configurations.

    python -m p_a_multigrids_tpu_torch.tune_amg [--device cuda|cpu]

The counterpart of the JAX system's ``scripts/tune_amg.py``: its seven
cases (``CASES``, name for name and knob for knob) of the production
bare-iteration configuration (``BASE``: one geometric level corrected by
strength-filtered SA), each measured as the script measures it, printed as
ONE JSON line on stdout ({"metric", "cases", "extra"}); progress marks go
to stderr.  It runs on the card unless the caller asks for the CPU: every
Chebyshev phase and zero-round apply launches kernel K1, every SA rowop
kernel K2.  Each case is built, measured and freed before the next.

What differs from ``scripts/tune_amg.py``:

- the mesh is the generated stand-in ``bench.BENCH_MESH`` after
  ``rcm_reorder``, as the script reorders untitled8192.msh (393,216 DOF at
  n_split 2), which ``extra.stand_in_for`` names;
- the port has only the transposed cycle, so the cycle is timed as
  ``_vcycle_t(0, x_t, b_t)`` with ``b_t = _rhs_t(x_t)``; the script's
  natural-layout ``_vcycle`` transposes around the same cycle;
- each timed window is eager PyTorch (``bench._timed``): the best of 3
  windows of ``N_CYCLES`` chained cycles, timed by CUDA events with one
  synchronise a window, after one untimed call; nothing is jitted; the K1
  and K2 libraries are built before the first setup timer starts;
- PCG (``bench._pcg_chain`` with one solve) reads its residual norm on the
  host once an iteration, inside the timed solve, and the window also
  holds the chain's seed for a next solve (a sum and an add);
- a case that raises leaves {"name", "error"} in its row and its message
  in ``extra.errors``; the line is still printed and the process exits 1
  (the script prints FAILED and exits 0);
- the numbers are printed unrounded, each row with the kernels' launches in
  its case and its knobs; ``extra.device`` is the card's name and power
  limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import bench
from .mesh import structured, topology
from .ops import phase as K
from .ops import spmv as K2
from .ops.fused import to_t

# scripts/tune_amg.py's SemiConfig fields shared by every case (with
# ntime = n_multigrid = 1, as bench._solver_for sets them), and its cases
BASE = dict(dt=0.05, n_split=2, multi_levels=1, amg=True)
CASES = [
    ("deg16-sw2 (r4 prod)", dict(cheb_degree=16, cheb_lower=0.05,
                                 agg_strength=0.5)),
    ("deg16-sw1", dict(cheb_degree=16, cheb_lower=0.05,
                       agg_strength=0.5, agg_sweeps=1)),
    ("deg12-sw1", dict(cheb_degree=12, cheb_lower=0.05,
                       agg_strength=0.5, agg_sweeps=1)),
    ("deg10-sw1", dict(cheb_degree=10, cheb_lower=0.06,
                       agg_strength=0.5, agg_sweeps=1)),
    ("deg12-sw2", dict(cheb_degree=12, cheb_lower=0.05,
                       agg_strength=0.5)),
    ("deg16-sw1-t8", dict(cheb_degree=16, cheb_lower=0.05,
                          agg_strength=0.5, agg_sweeps=1,
                          agg_target=8)),
    ("deg12-sw1-t8", dict(cheb_degree=12, cheb_lower=0.05,
                          agg_strength=0.5, agg_sweeps=1,
                          agg_target=8)),
]
# cycles a timed window, as the script's scan length
N_CYCLES = 30


def _launches() -> dict:
    return {"k1_phase": K.KERNEL.launches, "k2_rowop": K2.KERNEL.launches}


def solver(mesh, knobs: dict, device, dtype: str = "float32"):
    """One case's SemiSolver on ``device`` (``dtype`` other than float32
    only in the tests)."""
    return bench._solver_for(mesh, device=device, dtype=dtype,
                             **BASE, **knobs)


def run_case(mesh, name: str, knobs: dict, device,
             dtype: str = "float32") -> dict:
    """One case measured as the script measures it: setup seconds, ms a
    cycle, rho of the linear cycle from a float32 draw, ms to a 1e6 drop,
    PCG iterations and ms to 1e-6; with the kernels' launches and the
    knobs."""
    before = _launches()
    t0 = time.perf_counter()
    s = solver(mesh, knobs, device, dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    x_t = to_t(s.initial_condition())
    b_t = s._rhs_t(x_t)
    per = bench._timed(lambda x: s._vcycle_t(0, x, b_t), x_t, n=N_CYCLES)
    rho = bench._rho_linear(s, draw_dtype="float32")
    its, pcg_ms = bench._pcg_chain(s, solves=1)
    return {"name": name, "ms_per_cycle": per * 1e3, "rho": rho,
            "ms_to_1e6": bench._t_to(per, rho) * 1e3,
            "pcg_its_to_1e6": its, "pcg_ms_to_1e6": pcg_ms,
            "setup_s": setup_s,
            "launches": {k: v - before[k] for k, v in _launches().items()},
            "knobs": knobs}


def main(argv=None) -> int:
    """Run the sweep, print its JSON line; 0, or 1 when a case failed."""
    ap = argparse.ArgumentParser(prog="p_a_multigrids_tpu_torch.tune_amg")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("tune_amg: no CUDA device (--device cpu runs "
                             "on the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
        torch.zeros(1, device=device)
        K.KERNEL.function(torch.float32)     # the builds stay out of setup_s
        K2.KERNEL.function(torch.float32)
        bench._mark("kernels built")
    mesh = topology.rcm_reorder(structured.tri_mesh(*bench.BENCH_MESH))
    rows, errors = [], {}
    for name, knobs in CASES:
        try:
            rows.append(run_case(mesh, name, knobs, device))
            bench._mark(f"{name} measured")
        except Exception as e:
            errors[name] = bench._message(e)
            rows.append({"name": name, "error": errors[name]})
            bench._mark(f"{name} failed: {errors[name]}")
        bench._free(device)
    try:
        dev_name = bench._device_name(device)
    except Exception as e:
        errors["device"] = bench._message(e)
        dev_name = None
    print(json.dumps({
        "metric": "amg_knob_sweep",
        "cases": rows,
        "extra": {
            "device": dev_name,
            "stand_in_for": (f"untitled8192.msh: rcm_reorder(tri_mesh"
                             f"{bench.BENCH_MESH})"),
            "ndof": mesh.num_elements * 4 ** BASE["n_split"] * 3,
            # the kernels' launches over the whole sweep
            "launches": _launches(),
            "errors": errors,
        },
    }), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

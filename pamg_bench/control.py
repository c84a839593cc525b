"""The control of a cell's comparison: the reference, computed in TF32, in
the program's place.

    python3 -m pamg_bench.control --workload W --seed N [--seed N ...]

For each seed it makes the run's initial states (on the card where there
is one, as a run does), steps through the mix's first ``sample`` steps
with the control's own states (``reference.check``'s ``control``) and
prints one JSON line with the worst compared number beside the cell's
limit.  A sound limit lies below every control reading: the control must
come out as not correct.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import spec, traffic
from .reference import check as ref_check
from .reference import dg

ROOT = Path(__file__).resolve().parents[1]


def control_reading(workload: str, seed: int, root: Path = ROOT,
                    pkg: Path = spec.PKG, device=None) -> dict:
    """The control's worst number over the mix's first ``sample`` steps
    of ``seed``."""
    cell = spec.load_cell(root, workload, False, pkg)
    mix = cell.traffic
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    X = dg.structured_macro_X(*cell.config["mesh"]["tri_mesh"])
    n = cell.config["semi"]["n_split"]
    dtype = getattr(torch, cell.semi_fields().get("dtype", "float32"))
    ics = traffic.initial_states(dg.child_coords(X, n), mix, seed, device,
                                 dtype)
    ics = [ic.double().cpu().numpy().reshape(-1) for ic in ics]
    order = traffic.episode_order(seed, len(ics), device)
    check = ref_check.CHECKS[mix["check"]](X, cell.semi_fields())
    pairs, x = [], None
    for i in range(int(mix["sample"])):
        if i % int(mix["episode_steps"]) == 0:
            x = ics[order[(i // int(mix["episode_steps"])) % len(order)]]
        T_prev, x = x, check.control(x)
        pairs.append((T_prev, x))
    return {"workload": workload, "seed": seed,
            "control": {check.name: ref_check.worst(check, pairs)},
            "limit": {check.name: float(cell.limits[check.name])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    for seed in args.seed:
        print(json.dumps(control_reading(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What a cell is made of, found by name from ``BENCHMARK.json``.

- a configuration: the ``file`` its entry names (``configs/<name>.json``):
  the mesh, the SemiConfig fields of the problem, its source and cuts;
- a traffic mix: ``traffic/<name>.json``: the solver's SemiConfig fields,
  the episodes and initial states, the check that decides ``correct``;
- the cell's limits: ``limits/<cell>.json``: each compared number's limit
  and the readings it was set from;
- a metric: ``metrics/<name>.py``, a module with ``LAYER``, ``SOURCE``,
  ``MOVES`` and ``read(record)``, which returns the metric's value or
  None where the record holds nothing to read.

A new configuration, mix, metric or cell is new files and new entries;
no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    metrics: list            # (name, unit, module) to report, in order

    def semi_fields(self) -> dict:
        """The SemiConfig fields of the cell: the configuration's, then
        the mix's."""
        return {**self.config["semi"], **self.traffic["semi"]}


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(name: str, pkg: Path = PKG):
    """The reader module of metric ``name`` (``metrics/<name>.py``)."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pamg_bench_metric_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"metric {name!r}: no {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("LAYER", "SOURCE", "MOVES", "read"):
        if not hasattr(mod, attr):
            raise AttributeError(f"metric {name!r}: {path} has no {attr}")
    return mod


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    without a trace, the per-layer ones with it; each listed for the cell,
    or, without a ``workloads`` key, for every cell that reports the
    end-to-end metric it moves."""
    def listed(m):
        return m.get("workloads") is None or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def load_cell(root: Path, workload: str, trace: bool = False,
              pkg: Path = PKG) -> Cell:
    """The cell ``workload`` of the benchmark at ``root``, with the files
    its names lead to under ``pkg``."""
    bench = load_benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {root}/BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = _json(Path(root) / conf["file"])
    traffic = _json(pkg / "traffic" / f"{entry['traffic']}.json")
    limits = _json(pkg / "limits" / f"{workload}.json")
    metrics = [(m["name"], m["unit"], load_metric(m["name"], pkg))
               for m in metrics_of(bench, workload, trace)]
    return Cell(name=workload, config=config, traffic=traffic,
                limits=limits, chips=int(entry["chips"]), metrics=metrics)

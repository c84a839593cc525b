"""A tiny copy of the benchmark for the CPU tests: the repository's
``BENCHMARK.json`` and data files, with each configuration's mesh cut to
a few macros (the tri8192 stand-in's coarse level then fits the dense
coarse solve, so its cap is set to 0 to keep the cells' Chebyshev coarse
phase)."""

import json
import shutil
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
TINY = {"tri8192_ns2": ([12, 4, 0.25, 0.25], 2, {"coarse_direct_max_dof": 0}),
        "sweep98304_ns5": ([1, 1, 1.0, 0.75], 5, {})}


def make_tiny(dest: Path) -> Path:
    """A benchmark root at dest whose package data lie in dest / "pkg"."""
    pkg = dest / "pkg"
    for d in ("traffic", "metrics", "limits"):
        shutil.copytree(PKG / d, pkg / d)
    (pkg / "configs").mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        mesh, n_split, semi = TINY[c["name"]]
        conf["mesh"]["tri_mesh"] = mesh
        conf["semi"].update(n_split=n_split, **semi)
        c["file"] = f"pkg/configs/{c['name']}.json"
        (dest / c["file"]).write_text(json.dumps(conf))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("tiny"))

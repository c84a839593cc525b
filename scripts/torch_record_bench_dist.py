"""Record the targets of the port's distributed bench on the card,
p_a_multigrids_tpu_torch/validation/bench_dist_pins.json.

    PYTHONPATH=. python scripts/torch_record_bench_dist.py

Builds the JAX package's ``DistributedStencilSolver`` on the CPU, in
float32, on 8 virtual devices (as tests/conftest.py sets them up), with the
configurations and stand-in meshes of ``p_a_multigrids_tpu_torch.
bench_dist`` (``DIST8_MESH`` for untitled8192.msh, ``OVERHEAD_MESH`` for
900_ele.msh; ``DIST_BENCH_r05.json``, whose mesh is absent, is never read),
and records for D = 1, 2, 4, 8:

- ``dist8``: each configuration's ``ghost_report()`` (with
  ``pallas_phase=True``, which builds the phase tables on the CPU), the
  per-device work fraction of ``scripts/bench_dist8.py`` and
  ``amg_dist_engaged``; the (2, D/2) mesh shape at D = 4 and 8;
- ``retention``: ``scripts/bench_dist_tpu.ghost_model_at(..., 8)`` from
  the one-device solver on the RCM-reordered mesh;
- ``overhead``: ``dist.W`` (the largest level W) and the ghost report.

Where reference defect 2 moves a JAX ``redundant_frac`` (a short last
chunk: the JAX code counts ``chunk`` rounds on the final geometry, the
port ``R - chunk ((R - 1) // chunk)``), and where the JAX model's
``He_mid`` names a geometry no solver builds (one chunk a phase: the
solvers report He), the pin holds the corrected value and keeps the JAX one
beside it under ``<key>_jax``, with ``corrected`` saying why.  About a
minute on 8 CPU cores.
"""

import importlib.util
import json
import os
import pathlib
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from p_a_multigrids_tpu.config import SemiConfig  # noqa: E402
from p_a_multigrids_tpu.mesh import structured, topology  # noqa: E402
from p_a_multigrids_tpu.parallel.stencil_solver import (  # noqa: E402
    DistributedStencilSolver)

from p_a_multigrids_tpu_torch import bench_dist as bd  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PINS = (REPO / "p_a_multigrids_tpu_torch" / "validation"
        / "bench_dist_pins.json")
WORLDS = (1, 2, 4, 8)
MODEL_AT = 8
DEFECT2 = ("reference defect 2: the JAX code runs the last chunk of a "
           "phase on the final geometry for chunk rounds; it runs R - chunk "
           "((R - 1) // chunk)")
NO_MID = ("one chunk a phase: the JAX model's He_mid (chunk W) is a "
          "geometry no solver builds; both solvers report He")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frac(R, chunk, He, He_mid, U_loc) -> float:
    final = R - chunk * ((R - 1) // chunk)
    n_mid = R - final if He_mid < He else 0
    return round(2.0 * (n_mid * He_mid + (R - n_mid) * He) / R / U_loc, 4)


def corrected(levels: list) -> tuple:
    """(levels with the port's values, the reasons, or [] where none
    moved)."""
    out, why = [], set()
    for g in levels:
        g = dict(g)
        if g["chunk"] >= g["rounds"] and g["He_mid"] != g["He"]:
            g["He_mid_jax"], g["He_mid"] = g["He_mid"], g["He"]
            why.add(NO_MID)
        frac = _frac(g["rounds"], g["chunk"], g["He"], g["He_mid"],
                     g["U_loc"])
        if frac != g["redundant_frac"]:
            g["redundant_frac_jax"], g["redundant_frac"] = (
                g["redundant_frac"], frac)
            why.add(DEFECT2)
        out.append(g)
    return out, sorted(why)


def work_fraction(levels: list, U: int) -> float:
    """``scripts/bench_dist8.py``'s aggregate-work model."""
    return float(np.mean([(1.0 + g["redundant_frac"]) * g["U_loc"] / U
                          for g in levels]))


def _solver(mesh, kw: dict, D: int, frac: float = 0.25, mesh_shape=None):
    cfg = SemiConfig(**{**bd.BASE, **kw, "dist_ghost_max_frac": frac,
                        "pallas_phase": True})
    return DistributedStencilSolver(mesh, cfg, devices=jax.devices()[:D],
                                    mesh_shape=mesh_shape)


def _report_pin(d) -> dict:
    levels, why = corrected(d.ghost_report())
    pin = {"ghost_report": levels,
           "per_chip_work_fraction": work_fraction(levels, d.U), "U": d.U}
    if why:
        pin["per_chip_work_fraction_jax"] = work_fraction(
            d.ghost_report(), d.U)
        pin["corrected"] = why
    return pin


def main():
    assert len(jax.devices()) >= 8, "needs the 8 virtual CPU devices"
    t0 = time.time()
    out = {"source": (
        "scripts/torch_record_bench_dist.py: the JAX package's "
        "DistributedStencilSolver on the CPU, float32, 8 virtual devices; "
        f"untitled8192.msh stand-in tri_mesh{tuple(bd.DIST8_MESH)}, "
        f"900_ele.msh stand-in tri_mesh{tuple(bd.OVERHEAD_MESH)}"),
        "dist8": {}, "retention": {}, "overhead": {}}
    mesh = structured.tri_mesh(*bd.DIST8_MESH)
    for D in WORLDS:
        pins = out["dist8"][f"D{D}"] = {}
        for name, kw, two_d, frac in bd.DIST8_RUNS:
            if two_d and not (D >= 4 and D % 2 == 0):
                continue
            shape = (2, D // 2) if two_d else None
            d = _solver(mesh, kw, D, frac, shape)
            pins[name] = dict(_report_pin(d),
                              mesh_shape=list(shape or [D]),
                              amg_dist_engaged=bool(d._agg_li is not None
                                                    and d.D > 1))
            print(f"[dist8] D={D} {name}: {pins[name]['ghost_report']} "
                  f"({time.time() - t0:.0f} s)", file=sys.stderr, flush=True)
    script = _load("bench_dist_tpu")
    rmesh = topology.rcm_reorder(mesh)
    for name, kw in bd.RETENTION_RUNS:
        cfg = SemiConfig(**{**bd.BASE, **kw})
        d = DistributedStencilSolver(rmesh, cfg, devices=jax.devices()[:1])
        model, why = corrected(script.ghost_model_at(d.serial, cfg,
                                                     MODEL_AT))
        out["retention"][name] = {f"ghost_model_at_D{MODEL_AT}": model}
        if why:
            out["retention"][name]["corrected"] = why
        print(f"[retention] {name}: {model}", file=sys.stderr, flush=True)
    omesh = structured.tri_mesh(*bd.OVERHEAD_MESH)
    for D in WORLDS:
        d = _solver(omesh, bd.OVERHEAD, D)
        out["overhead"][f"D{D}"] = dict(_report_pin(d), halo_window_W=d.W)
        print(f"[overhead] D={D}: W={d.W}", file=sys.stderr, flush=True)
    PINS.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {PINS.relative_to(REPO)} in {time.time() - t0:.0f} s",
          file=sys.stderr)


if __name__ == "__main__":
    main()

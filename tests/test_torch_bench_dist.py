"""The port's distributed bench (p_a_multigrids_tpu_torch/bench_dist.py)
against the JAX system's scripts/bench_dist8.py, bench_dist_tpu.py and
bench_distributed.py, on the CPU at a small size.

``ghost_model_at`` and the solver's ``ghost_report`` come from one rule
(``stencil_solver.ghost_plan``): they agree on every level for D = 2, 4, 8;
the model agrees with ``bench_dist_tpu.ghost_model_at`` (loaded from the
script; the JAX file is not edited) wherever reference defect 2 does not
apply, and differs where the last chunk is short by exactly the final-chunk
correction.  ``main`` runs on 8 CPU ranks (dist8 and overhead) and on 1
(retention) with the stand-in meshes shrunk and one window of one call:
each dist8 configuration's ghost report, work fraction and
``amg_dist_engaged`` equal the JAX DistributedStencilSolver's on the 8
virtual devices, the (2, 4) mesh shape included, and overhead's halo
window W equals its ``W``.  Integers exactly, fractions to 1e-12."""

import torch_threads  # noqa: F401

import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu.config import SemiConfig as JConfig
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.mesh import topology as jtopo
from p_a_multigrids_tpu.parallel.stencil_solver import (
    DistributedStencilSolver as JDist)

from p_a_multigrids_tpu_torch import bench_dist
from p_a_multigrids_tpu_torch.mesh import structured, topology
from p_a_multigrids_tpu_torch.parallel import cases
from p_a_multigrids_tpu_torch.parallel.stencil_solver import (
    DistributedStencilSolver, ghost_model_at)

REPO = pathlib.Path(__file__).resolve().parents[1]
MESH = (8, 4, 0.25, 0.25)              # 64 macros: U_loc 8 at 8 ranks
WIDE = (16, 4, 0.25, 0.25)             # 128 macros
OVERHEAD_MESH = (4, 4, 0.25, 0.25)     # 32 macros at n_split 3
CONFIGS = {"geometric": bench_dist.GEOMETRIC,
           "production_amg": bench_dist.PRODUCTION}
FRAC_TOL = 1e-12


class _Ranks:
    """A stand-in for ``comm.RingComm`` on rank 0 of ``world``: the
    solver's setup makes no collective call."""

    def __init__(self, world):
        self.world, self.rank, self.device = world, 0, torch.device("cpu")


def _cfg(kw, frac=0.25) -> dict:
    return {**bench_dist.BASE, **kw, "dist_ghost_max_frac": frac}


def _port(mesh, cfg: dict, D: int):
    return DistributedStencilSolver(structured.tri_mesh(*mesh),
                                    cases.config(cfg), _Ranks(D))


def _jax(mesh, cfg: dict, D: int, mesh_shape=None):
    return JDist(jstruct.tri_mesh(*mesh), JConfig(**cfg),
                 devices=jax.devices()[:D], mesh_shape=mesh_shape)


@pytest.fixture(scope="module")
def jscript():
    spec = importlib.util.spec_from_file_location(
        "bench_dist_tpu", REPO / "scripts" / "bench_dist_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(mesh, cfg: dict, D: int) -> list:
    """The port's model at D from the serial twin of one rank."""
    return ghost_model_at(_port(mesh, cfg, 1).serial, cases.config(cfg), D)


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("config,frac", [("geometric", 0.25),
                                         ("production_amg", 0.25),
                                         ("production_amg", 1e9)])
def test_ghost_model_equals_ghost_report(D, config, frac):
    cfg = _cfg(CONFIGS[config], frac)
    model = _model(MESH, cfg, D)
    report = _port(MESH, cfg, D).ghost_report()
    assert len(model) == len(report) > 0
    for m, r in zip(model, report):
        r = dict(r)
        del r["n_exchanges"]
        assert {k: v for k, v in m.items() if k != "deep_ghost_frac"} == r


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_ghost_model_matches_the_jax_script(jscript, D, config):
    """Every chunk here is 1 (R % chunk == 0): every key equal."""
    cfg = _cfg(CONFIGS[config])
    want = jscript.ghost_model_at(_jax(MESH, cfg, 1).serial, JConfig(**cfg),
                                  D)
    got = _model(MESH, cfg, D)
    assert [g["chunk"] for g in got] == [1] * len(got)
    assert got == want


def test_ghost_model_where_phases_do_not_split(jscript):
    """One deep-ghost chunk (chunk = R): the JAX model's He_mid is chunk W,
    a geometry neither package's solver builds; the port's model gives He,
    as both packages' ghost_report do.  Every other key equal."""
    cfg = _cfg(bench_dist.PRODUCTION, 1e9)
    want = jscript.ghost_model_at(_jax(WIDE, cfg, 1).serial, JConfig(**cfg),
                                  4)
    got = _model(WIDE, cfg, 4)
    jreport = _jax(WIDE, dict(cfg, pallas_phase=True), 4).ghost_report()
    for g, w, jr in zip(got, want, jreport):
        assert g["chunk"] == g["rounds"]
        assert g["He_mid"] == g["He"] == jr["He_mid"] != w["He_mid"]
        assert w["He_mid"] == g["chunk"] * g["W"] < 128
        assert {k: v for k, v in g.items() if k != "He_mid"} == {
            k: v for k, v in w.items() if k != "He_mid"}


def test_ghost_model_corrects_the_short_last_chunk(jscript):
    """Chunk 4 of 6 rounds at level 0 (12 at level 1): the JAX model runs
    chunk rounds on the final geometry, the port final = R - chunk ((R -
    1) // chunk) = 2; the two fractions differ by 2 (final - chunk) (He -
    He_mid) / (R U_loc) before rounding (reference defect 2)."""
    cfg = _cfg(bench_dist.GEOMETRIC, 1.6)
    want = jscript.ghost_model_at(_jax(WIDE, cfg, 1).serial, JConfig(**cfg),
                                  4)
    got = _model(WIDE, cfg, 4)
    assert [(g["chunk"], g["rounds"]) for g in got] == [(4, 6), (4, 12)]
    for g, w in zip(got, want):
        R, chunk, He, He_mid, U_loc = (g[k] for k in (
            "rounds", "chunk", "He", "He_mid", "U_loc"))
        assert {k: v for k, v in g.items() if k != "redundant_frac"} == {
            k: v for k, v in w.items() if k != "redundant_frac"}
        final = R - chunk * ((R - 1) // chunk)

        def frac(last):
            return 2.0 * ((R - last) * He_mid + last * He) / R / U_loc

        assert g["redundant_frac"] == round(frac(final), 4)
        assert w["redundant_frac"] == round(frac(chunk), 4)
        assert frac(final) - frac(chunk) == pytest.approx(
            2 * (final - chunk) * (He - He_mid) / (R * U_loc), abs=1e-15)
        assert (g["redundant_frac"] != w["redundant_frac"]) == bool(R % chunk)


def _small(mp):
    """main's stand-in meshes shrunk; one window of one call."""
    mp.setattr(bench_dist, "DIST8_MESH", MESH)
    mp.setattr(bench_dist, "OVERHEAD_MESH", OVERHEAD_MESH)
    for name in ("DIST8_CYCLES", "RETENTION_CYCLES", "OVERHEAD_STEPS",
                 "REPS"):
        mp.setattr(bench_dist, name, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """main on 8 CPU ranks (dist8, overhead) and on 1 (retention, with
    --out), each in an empty working directory: (rc, line, files left)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _small(mp)
        for n, extra in ((8, []), (1, ["--out", "line.json"])):
            where = tmp_path_factory.mktemp(f"bench_dist{n}")
            mp.chdir(where)
            rc, line = _run_main(["--device", "cpu", "--devices", str(n)]
                                 + extra)
            out[n] = (rc, line, sorted(p.name for p in where.iterdir()),
                      where)
    return out


def _run_main(argv) -> tuple:
    """(exit code, the JSON line) of main, which prints one line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_dist.main(argv)
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_main_on_cpu_ranks(runs):
    """One JSON line a run, exit 0, its sections; no DIST_BENCH*.json
    written, --out the only file; the CPU runs the kernels' plain
    versions."""
    rc8, line8, files8, _ = runs[8]
    rc1, line1, files1, where1 = runs[1]
    assert (rc8, rc1) == (0, 0) and line8["errors"] == line1["errors"] == {}
    assert set(line8) >= {"dist8", "overhead"} and "retention" not in line8
    assert set(line1) >= {"retention"} and "dist8" not in line1
    assert (line8["devices"], line8["backend"], line1["devices"]) == (
        8, "gloo", 1)
    assert files8 == [] and files1 == ["line.json"]
    assert json.loads((where1 / "line.json").read_text()) == line1
    assert set(line8["dist8"]["configs"]) == {r[0] for r in
                                              bench_dist.DIST8_RUNS}
    assert line8["dist8"]["left_out"] == {}
    for cfg in (list(line8["dist8"]["configs"].values())
                + [line8["overhead"]]
                + list(line1["retention"]["configs"].values())):
        assert set(cfg["launches"]) == {"k1_phase", "k2_rowop"}
        assert all(v == 0 for vs in cfg["launches"].values() for v in vs)
    assert "untitled8192.msh" in line8["extra"]["stand_in_for"]


def test_distributed_state_equals_the_twin(runs):
    """The cycles and steps run from T0 with the twin's right-hand side:
    geometric bit for bit, amg within float32 summation order."""
    line8, line1 = runs[8][1], runs[1][1]
    rel = {f"dist8.{k}": v["dist_vs_serial_rel"]
           for k, v in line8["dist8"]["configs"].items()}
    rel.update({f"retention.{k}": v["dist_vs_serial_rel"]
                for k, v in line1["retention"]["configs"].items()})
    rel["overhead"] = line8["overhead"]["dist_vs_serial_rel"]
    for k, v in rel.items():
        assert v == 0.0 if ("geometric" in k or k == "overhead"
                            or k.startswith("retention")) else v < 1e-5, k


@pytest.mark.parametrize("name", [r[0] for r in bench_dist.DIST8_RUNS])
def test_dist8_matches_jax_at_8(runs, name):
    got = runs[8][1]["dist8"]["configs"][name]
    _, kw, two_d, frac = next(r for r in bench_dist.DIST8_RUNS
                              if r[0] == name)
    shape = (2, 4) if two_d else None
    jd = _jax(MESH, dict(_cfg(kw, frac), pallas_phase=True), 8, shape)
    want = jd.ghost_report()
    assert got["ghost_report"] == want
    assert got["mesh_shape"] == list(shape or [8])
    work = np.mean([(1.0 + g["redundant_frac"]) * g["U_loc"] / jd.U
                    for g in want])
    assert abs(got["per_chip_work_fraction"] - work) <= FRAC_TOL
    assert abs(got["ideal_speedup_at_D8"] - 1 / work) <= FRAC_TOL / work ** 2
    assert got["amg_dist_engaged"] == (jd._agg_li is not None and jd.D > 1)
    assert got["sa_rows"] == [got["amg_dist_engaged"]] * 8


def test_overhead_window_matches_jax(runs):
    got = runs[8][1]["overhead"]
    jd = _jax(OVERHEAD_MESH, _cfg(bench_dist.OVERHEAD), 8)
    assert got["halo_window_W"] == jd.W
    assert (got["n_macro"], got["children"], got["devices"]) == (32, 64, 8)
    assert got["ndof"] == 32 * 64 * 3


def test_retention_at_one_rank(runs, jscript):
    """retention's model at D = 8, from the twin on the RCM-reordered mesh,
    equals bench_dist_tpu.py's on the same reordering (chunk 1)."""
    for name, r in runs[1][1]["retention"]["configs"].items():
        assert r["d1_serial_agg_shortcircuit"] and r["d1_ghost_zones_empty"]
        assert r["amg_tables_built"] == (name == "production_amg")
        assert r["k1_phase_dist"] is False       # the CPU's plain version
        cfg = _cfg(CONFIGS[name])
        jd = JDist(jtopo.rcm_reorder(jstruct.tri_mesh(*MESH)),
                   JConfig(**cfg), devices=jax.devices()[:1])
        want = jscript.ghost_model_at(jd.serial, JConfig(**cfg), 8)
        assert r["ghost_model_at_D8"] == want
        port = DistributedStencilSolver(
            topology.rcm_reorder(structured.tri_mesh(*MESH)),
            cases.config(cfg), _Ranks(1))
        assert want == ghost_model_at(port.serial, cases.config(cfg), 8)


def test_a_failed_section_is_reported(monkeypatch):
    def fail(n, device):
        raise RuntimeError("rank 1 of 2 failed first:\nTraceback\nboom")

    monkeypatch.setattr(bench_dist, "overhead", fail)
    rc, line = _run_main(["--device", "cpu", "--devices", "2",
                          "--section", "overhead"])
    assert rc == 1
    msg = "RuntimeError: rank 1 of 2 failed first: ... boom"
    assert line["errors"] == {"overhead": msg}
    assert line["overhead"] == {"error": msg}


@pytest.mark.parametrize("argv,match", [
    (["--devices", "2", "--section", "retention"], "retention runs at"),
    (["--devices", "1", "--section", "dist8"], "dist8 runs at"),
    (["--out", "DIST_BENCH_r05.json"], "JAX system's records")])
def test_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        bench_dist.main(["--device", "cpu"] + argv)

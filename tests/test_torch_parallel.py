"""The port's distributed solvers (p_a_multigrids_tpu_torch.parallel) ==
the JAX package's (p_a_multigrids_tpu.parallel) on the CPU, in float64.

The port runs one process a rank over torch.distributed (gloo on the CPU);
one pool of ranks a world size runs every case of that size
(``parallel.cases.run_cases``, in a module-scoped fixture), with one BLAS
thread a rank; the JAX references run in this process on the virtual CPU
devices, on one thread too (tests/torch_threads.py).  Tolerances are those
of the JAX package's own tests/test_parallel.py (1e-11 / 1e-12 geometric,
1e-8 Krylov, 1e-9 coarse Krylov, amg and coarse_agg); each geometric case
also equals the port's serial twin on the same reordered mesh bit for bit.
"""

import torch_threads  # noqa: F401

import json
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import __main__ as jcli
from p_a_multigrids_tpu.config import Physics as JPhysics
from p_a_multigrids_tpu.config import SemiConfig as JSemiConfig
from p_a_multigrids_tpu.mesh import structured as jstructured
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.parallel import halo as jhalo
from p_a_multigrids_tpu.parallel import partition as jpartition
from p_a_multigrids_tpu.parallel.solver import DistributedSemiSolver
from p_a_multigrids_tpu.parallel.stencil_solver import (
    DistributedStencilSolver)

from p_a_multigrids_tpu_torch import __main__ as tcli
from p_a_multigrids_tpu_torch import entry as tentry
from p_a_multigrids_tpu_torch.io import checkpoint as tckpt
from p_a_multigrids_tpu_torch.mesh import structured, topology
from p_a_multigrids_tpu_torch.models import semi as tsemi
from p_a_multigrids_tpu_torch.parallel import cases, comm, halo, partition

REPO = pathlib.Path(__file__).resolve().parents[1]
MESH = [16, 4, 0.25, 0.25]                   # 128 macros
GEO = dict(n_split=2, multi_levels=2, dt=0.5, ntime=1, n_multigrid=2,
           dtype="float64")
AMG = dict(n_split=2, multi_levels=1, dt=0.5, ntime=1, n_multigrid=2,
           amg=True, agg_strength=0.3, dtype="float64")
GEO_TOL = (1e-11, 1e-12)                     # rtol, atol

# id: (ranks, macro mesh, config, extra case keys, (rtol, atol) against the
# JAX package or None, (rtol, atol) against the serial twin: None = bits)
SPECS = {
    "geo": (8, MESH, dict(GEO, dt=0.05, ntime=2), {}, GEO_TOL, None),
    "geo_2d": (8, MESH, dict(GEO, dt=0.05, ntime=2),
               {"mesh_shape": (2, 4)}, None, None),
    "krylov": (4, MESH, dict(GEO, krylov=True, krylov_tol=1e-10), {},
               (1e-8, 1e-8), (1e-8, 1e-8)),
    "coarse_krylov": (4, MESH, dict(GEO, coarse_krylov=True,
                                    coarse_direct_max_dof=0), {},
                      (1e-9, 1e-9), (1e-9, 1e-9)),
    "wcycle": (2, MESH, dict(GEO, n_multigrid=1, cycle_type="w"), {},
               GEO_TOL, None),
    # n_split 4 (C = 256); its 12,288-DOF coarsest continues into SA levels
    # (coarse_agg), which the serial twin corrects through its factored
    # transfers: not bit for bit there
    "deep": (4, [16, 2, 0.25, 0.25], dict(GEO, n_split=4, n_multigrid=1),
             {}, GEO_TOL, GEO_TOL),
    "amg": (4, MESH, AMG, {}, (1e-9, 1e-9), (1e-9, 1e-9)),
    "amg_gate": (4, MESH, dict(AMG, dt=1e8, ntime=2), {}, (1e-9, 1e-9),
                 (1e-9, 1e-9)),
    "coarse_agg": (4, MESH, dict(GEO, coarse_agg=True,
                                 coarse_direct_max_dof=0), {},
                   (1e-9, 1e-9), (1e-9, 1e-9)),
    # ghost zones over several ranks: 8 ranks on 32 macros (k-hop halos)
    "multihop": (8, [8, 2, 0.25, 0.25],
                 dict(n_split=1, multi_levels=1, dt=0.5, ntime=1,
                      n_multigrid=1, n_smooth=2, cheb_degree=2,
                      dtype="float64"), {}, GEO_TOL, None),
    # a band wider than a rank's block: 8 ranks on 24 macros
    "wide": (8, [4, 3, 0.25, 0.25],
             dict(n_split=1, multi_levels=1, dt=0.5, ntime=1, n_multigrid=1,
                  dtype="float64"), {}, GEO_TOL, None),
    "theta": (4, MESH, dict(GEO, theta=0.5), {}, (1e-9, 1e-9), (1e-9, 1e-9)),
    "bicgstab": (4, MESH, dict(GEO, dt=0.05, krylov=True, krylov_tol=1e-10,
                               physics=dict(advection=True, u=(1.0, 0.5))),
                 {}, None, (1e-8, 1e-8)),
    # chunk 1 with the mid geometry, and one deep-ghost chunk
    "frac0": (4, MESH, dict(GEO, dist_ghost_max_frac=0.0), {}, None, None),
    "frac_inf": (4, MESH, dict(GEO, dist_ghost_max_frac=1e9), {}, None,
                 None),
    # chunk 4 of 6 rounds at level 0: R % chunk != 0
    "ghost": (4, MESH, dict(GEO, dist_ghost_max_frac=1.6), {}, None, None),
}
SEMI = dict(n_split=1, multi_levels=2, dt=0.1, ntime=1, n_multigrid=1,
            dtype="float64")
SEMI_MESH = [8, 4, 0.125, 0.25]
RINGS = [(2, 5, 3), (2, 5, 12), (4, 5, 4), (4, 3, 11), (8, 4, 2),
         (8, 2, 9)]                          # (ranks, U_loc, H)


def _jax_cfg(spec: dict) -> JSemiConfig:
    spec = dict(spec)
    if "physics" in spec:
        spec["physics"] = JPhysics(**spec["physics"])
    return JSemiConfig(**spec)


def _jax_dist(mesh, cfg: dict, ranks: int, load=None, save=None):
    """JAX DistributedStencilSolver's final state (U_active, C, 3)."""
    d = DistributedStencilSolver(jstructured.tri_mesh(*mesh), _jax_cfg(cfg),
                                 devices=jax.devices()[:ranks])
    T, step = (d.load_checkpoint(load) if load else
               (d.initial_condition(), 0))
    T = d.run(T)
    if save:
        d.save_checkpoint(save, T, step + cfg["ntime"])
    return d.to_std(T)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A checkpoint that the JAX distributed solver wrote after one step of
    the geometric configuration on 4 devices."""
    d = tmp_path_factory.mktemp("ckpt")
    _jax_dist(MESH, GEO, 4, save=str(d / "jax_d.npz"))
    return d


@pytest.fixture(scope="module")
def results(ckpt_dir):
    """Every case, one pool a world size; rank 0's results by id."""
    by_world = {}
    for cid, (ranks, mesh, cfg, extra, _, _) in SPECS.items():
        by_world.setdefault(ranks, []).append(dict(
            id=cid, kind="stencil", mesh=mesh, cfg=cfg, ntime=cfg["ntime"],
            serial=True, **extra))
    for ranks, U_loc, H in RINGS:
        by_world[ranks].append(dict(id=f"ring{ranks}_{U_loc}_{H}",
                                    kind="ring", U_loc=U_loc, H=H,
                                    seed=ranks + H))
    by_world[8].append(dict(id="semi", kind="semi", mesh=SEMI_MESH,
                            cfg=SEMI, ntime=1))
    for ranks in by_world:
        by_world[ranks].append(dict(id=f"imports{ranks}", kind="imports"))
    base = dict(kind="stencil", mesh=MESH, cfg=GEO)
    by_world[4] += [
        dict(base, id="ck_straight", ntime=2),
        dict(base, id="ck_first", ntime=1, save=str(ckpt_dir / "d1.npz")),
        dict(base, id="ck_jax", ntime=1, load=str(ckpt_dir / "jax_d.npz"),
             save=str(ckpt_dir / "port_d.npz"))]
    # resumes the port's own file: after ck_first in the same pool
    by_world[4].append(dict(base, id="ck_resume", ntime=1,
                            load=str(ckpt_dir / "d1.npz")))
    out = {}
    t0 = time.time()
    for ranks, cs in sorted(by_world.items()):
        out.update(comm.launch(cases.run_cases, ranks, "cpu", args=(cs,),
                               timeout=600)[0])
    out["_wall_s"] = time.time() - t0
    return out


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_ranks_import_no_jax(results, ranks):
    """After every case, no rank has loaded jax or the JAX package."""
    assert results[f"imports{ranks}"] == dict(most=0, names=[])


def test_partition_matches_jax():
    for rows, cols, parts in ((8, 8, 8), (3, 1, 4), (5, 3, 4)):
        mesh = structured.tri_mesh(rows, cols, 1 / rows, 1 / cols)
        jmesh = jstructured.tri_mesh(rows, cols, 1 / rows, 1 / cols)
        np.testing.assert_array_equal(partition.bfs_order(mesh.neig),
                                      jpartition.bfs_order(jmesh.neig))
        got = partition.partition_mesh(mesh, parts)
        want = jpartition.partition_mesh(jmesh, parts)
        assert (got.n_active, got.block) == (want.n_active, want.block)
        for f in ("X", "tri", "neig", "neigh_face", "dir_flag", "region_id"):
            a, b = getattr(got.mesh, f), getattr(want.mesh, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b)
        assert (partition.cut_fraction(got.mesh, parts)
                == jpartition.cut_fraction(want.mesh, parts))


def test_halo_plan_matches_jax():
    mesh = structured.tri_mesh(4, 2, 0.25, 0.25)
    for n_split, parts in ((1, 4), (2, 2), (2, 8)):
        L = tsemi.build_problem(partition.pad_mesh(mesh, parts)[0],
                                tsemi.SemiConfig(n_split=n_split)).levels[0]
        neigh = np.asarray(L["neigh_elem"])
        got, want = (halo.build_halo_plan(neigh, parts),
                     jhalo.build_halo_plan(neigh, parts))
        assert got.slots == want.slots
        for f in ("export_idx", "is_remote", "local_idx", "src_dev",
                  "src_slot"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("ranks,U_loc,H", RINGS)
def test_ring_halo_against_global_slices(results, ranks, U_loc, H):
    """ring_halo's left and right halos are the global array's slices,
    within one block (H < U_loc) and over several (H > U_loc)."""
    assert results[f"ring{ranks}_{U_loc}_{H}"] == 0.0


@pytest.mark.parametrize("cid", [c for c, s in SPECS.items() if s[4]])
def test_stencil_solver_matches_jax(results, cid):
    ranks, mesh, cfg, extra, (rtol, atol), _ = SPECS[cid]
    want = _jax_dist(mesh, cfg, ranks)
    np.testing.assert_allclose(results[cid]["std"], want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("cid", list(SPECS))
def test_stencil_solver_matches_serial_twin(results, cid):
    """The serial port solver on the same reordered mesh, from the same
    state, in rank 0: bit for bit on the geometric configurations."""
    r = results[cid]
    tol = SPECS[cid][5]
    if tol is None:
        np.testing.assert_array_equal(r["std"], r["serial"])
    else:
        np.testing.assert_allclose(r["std"], r["serial"], rtol=tol[0],
                                   atol=tol[1])
    if SPECS[cid][2].get("krylov"):
        # dots summed over the ranks in another order: one iteration apart
        # at most
        assert all(abs(a - b) <= 1 for a, b in zip(
            r["krylov_iters"], r["serial_krylov_iters"]))


def test_mesh_shape_and_ghost_cap_leave_bits_unchanged(results):
    """mesh_shape (2, 4) equals the 1-D ring bit for bit; chunked phases
    (cap 0: chunk 1, the mid geometry engaged) equal one deep-ghost chunk
    (cap 1e9) bit for bit."""
    np.testing.assert_array_equal(results["geo_2d"]["std"],
                                  results["geo"]["std"])
    np.testing.assert_array_equal(results["frac0"]["std"],
                                  results["frac_inf"]["std"])
    g0, ginf = results["frac0"]["ghost"][0], results["frac_inf"]["ghost"][0]
    assert g0["chunk"] == 1 and g0["n_exchanges"] > 1
    assert ginf["n_exchanges"] == 1 and ginf["He"] > g0["He"]
    assert any(lv["He_mid"] < lv["He"] for lv in results["frac0"]["ghost"])


def test_ghost_report_corrects_the_final_chunk(results):
    """Fields equal the JAX package's report, except redundant_frac where
    the last chunk is short (R % chunk != 0): there the port counts its
    final = R - chunk ((R - 1) // chunk) rounds on the final geometry, the
    JAX package chunk of them."""
    got = results["ghost"]["ghost"]
    jd = DistributedStencilSolver(
        jstructured.tri_mesh(*MESH),
        _jax_cfg(dict(SPECS["ghost"][2], pallas_phase=True)),
        devices=jax.devices()[:4])
    want = jd.ghost_report()
    assert len(got) == len(want) == 2
    short = 0
    for g, w in zip(got, want):
        for k in ("level", "W", "He", "He_mid", "chunk", "rounds", "U_loc",
                  "n_exchanges"):
            assert g[k] == w[k], (k, g, w)
        R, chunk = g["rounds"], g["chunk"]
        final = R - chunk * ((R - 1) // chunk)
        avg = 2.0 * ((R - final) * g["He_mid"] + final * g["He"]) / R
        assert g["redundant_frac"] == round(avg / g["U_loc"], 4)
        if R % chunk:
            short += 1
            assert g["redundant_frac"] != w["redundant_frac"]
        else:
            assert g["redundant_frac"] == w["redundant_frac"]
    assert short == 1


def test_semi_solver_matches_jax(results):
    r = results["semi"]
    jd = DistributedSemiSolver(jstructured.tri_mesh(*SEMI_MESH),
                               _jax_cfg(SEMI), devices=jax.devices()[:8])
    want = jd.active(jd.run())
    np.testing.assert_allclose(r["active"], want, rtol=1e-12, atol=1e-12)


def test_checkpoints_across_packages_and_solvers(results, ckpt_dir):
    """A resumed port run equals the straight one bit for bit; the port
    resumes the JAX distributed solver's file and the JAX distributed
    solver the port's; the serial port solver resumes the distributed
    one's file on the reordered mesh."""
    np.testing.assert_array_equal(results["ck_resume"]["std"],
                                  results["ck_straight"]["std"])
    assert results["ck_resume"]["step"] == 1
    assert results["ck_jax"]["step"] == 1
    np.testing.assert_allclose(results["ck_jax"]["std"],
                               results["ck_straight"]["std"], rtol=1e-11,
                               atol=1e-12)
    T, step, _, _ = tckpt.load(str(ckpt_dir / "port_d.npz"))
    assert step == 2
    np.testing.assert_array_equal(T, results["ck_jax"]["std"])
    # the JAX distributed solver, one more step from the port's file
    want3 = _jax_dist(MESH, GEO, 4, load=str(ckpt_dir / "port_d.npz"))
    # the serial port solver from the same file, on the same ordering
    mesh = topology.rcm_reorder(structured.tri_mesh(*MESH))
    serial = tsemi.SemiSolver(tsemi.build_problem(
        mesh, cases.config(GEO)), "cpu")
    got3 = serial.run(torch.as_tensor(T), 1).numpy()
    np.testing.assert_allclose(got3, want3, rtol=1e-11, atol=1e-12)


def test_cli_devices_matches_jax(capsys):
    argv = ["--mode", "9", "--rows", "4", "--cols", "4", "--ntime", "2",
            "--devices", "4"]
    jcli.main(argv + ["--cpu", "--f64"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tcli.main(argv + ["--device", "cpu", "--f64"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert set(got) == set(want)
    assert got["devices"] == 4 and got["children"] == want["children"]
    assert got["elements"] == want["elements"]
    assert got["L1_error"] == pytest.approx(want["L1_error"], rel=1e-9)


def test_cli_module_entry_point():
    """``python -m p_a_multigrids_tpu_torch --devices 2``: the spawned
    ranks import their program by name (a package's __main__ is not
    imported in a spawned process)."""
    res = subprocess.run(
        [sys.executable, "-m", "p_a_multigrids_tpu_torch", "--mode", "9",
         "--rows", "2", "--cols", "2", "--n-split", "1", "--levels", "2",
         "--ntime", "1", "--devices", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["devices"] == 2 and np.isfinite(out["L1_error"])


def test_dryrun_multichip():
    assert tentry.dryrun_multichip(4, "cpu") == [(128, 16, 3)] * 4


def test_failed_rank_fails_the_launch():
    """A rank that raises while the others wait in a collective (and then
    fail on the closed connection): launch raises the first failure, that
    rank's error, well within its deadline."""
    t0 = time.time()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 3 failed first.*"
                       "failed on purpose"):
        comm.launch(cases.fail_on, 3, "cpu", args=(1,), timeout=60,
                    pg_timeout=20)
    assert time.time() - t0 < 60


def test_refusals():
    """The JAX package's refusals, before any rank work."""
    class One:
        rank, world, device = 0, 1, "cpu"
    from p_a_multigrids_tpu_torch.config import Solver
    from p_a_multigrids_tpu_torch.parallel.stencil_solver import (
        DistributedStencilSolver as TDist)
    mesh = structured.tri_mesh(2, 2, 0.5, 0.5)
    for kw, msg in ((dict(solver=Solver.JACOBI), "Chebyshev"),
                    (dict(coarse_pack=2), "coarse_pack"),
                    (dict(n_split=7), "stencil operator"),
                    (dict(debug=True), "one device")):
        with pytest.raises(ValueError, match=msg):
            TDist(mesh, cases.config(kw), One())
    with pytest.raises(ValueError, match="mesh_shape"):
        TDist(mesh, cases.config({}), One(), mesh_shape=(2, 2))


def test_pool_wall_time(results):
    """The pools of this file stay well inside the tier-1 run's budget."""
    assert results["_wall_s"] < 300

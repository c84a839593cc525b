"""The rank programs of ``--devices N`` (``cli_rank``), of
``entry.dryrun_multichip`` (``dryrun_rank``) and of the distributed bench
(``bench_dist_rank``), for ``comm.launch``.

They live here, not beside their callers: a spawned rank imports its
program by module and name, and multiprocessing does not import a
package's ``__main__`` (``python -m p_a_multigrids_tpu_torch``) in a
spawned process.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import __main__ as cli
from ..config import SemiConfig
from ..mesh import structured, topology
from ..ops import phase as K1
from ..ops import spmv as K2
from ..ops.fused import to_t
from .cases import config
from .stencil_solver import DistributedStencilSolver, ghost_model_at


def cli_rank(comm, argv):
    """One rank of ``--devices N`` (the JAX CLI's distributed mode 9): the
    run from the initial condition or the --checkpoint file, saved every
    --checkpoint-every steps and at the end, traced into
    ``--profile``'s ``trace_rank<r>.json``; rank 0 returns the JSON keys
    and writes --vtu (in the solver's reordered macro order, padding
    removed)."""
    args = cli._parser().parse_args(argv)
    with cli._profiled(args.profile, comm.rank):
        out, solver, T = _cli_rank_run(comm, args)
    if comm.rank:
        return None
    if args.vtu:
        from ..io import vtu

        coords = vtu.semi_coords(solver.p.grid.macro.X, solver.cfg.n_split)
        vtu.write_vtu(args.vtu, coords[: T.shape[0] * T.shape[1]],
                      {"Tracer": T.reshape(-1, 3)}, cell_type=5)
        out["vtu"] = args.vtu
    return out


def _cli_rank_run(comm, args):
    """cli_rank's solve: (the JSON keys, the solver, the final state in
    the standard layout)."""
    cfg = cli._semi_cfg(args)
    mesh = cli._mesh(args)
    solver = DistributedStencilSolver(mesh, cfg, comm)
    out = {}
    T_t, start = solver.initial_condition(), 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        T_t, start = solver.load_checkpoint(args.checkpoint)
        out["resumed_from_step"] = start
    for step in range(start, cfg.ntime):
        T_t = solver.step(T_t)
        if args.checkpoint and ((step + 1) % args.checkpoint_every == 0
                                or step + 1 == cfg.ntime):
            solver.save_checkpoint(args.checkpoint, T_t, step + 1)
    T = solver.to_std(T_t)
    out.update(devices=comm.world, elements=mesh.num_elements,
               children=4 ** cfg.n_split,
               L1_error=float(solver.error(T_t).mean()))
    return out, solver, T


def dryrun_rank(comm, n_ranks: int):
    """One rank of ``dryrun_multichip``: the three configurations, and the
    production one on a (2, n/2) mesh shape; each ends finite."""
    macro = structured.tri_mesh(max(16, 2 * n_ranks), 4, 0.25, 0.25)
    geometric = SemiConfig(n_split=2, multi_levels=2, dt=0.05, ntime=1,
                           n_multigrid=1)
    # the production implicit path: W-cycle-preconditioned PCG with dots
    # summed over the ranks
    krylov_w = SemiConfig(n_split=2, multi_levels=2, dt=0.5, ntime=1,
                          krylov=True, krylov_tol=1e-6, cycle_type="w")
    # the production bare-iteration configuration: K1 phases on extended
    # domains and the sharded SA correction through K2
    production = SemiConfig(n_split=2, multi_levels=1, dt=0.5, ntime=1,
                            n_multigrid=1, amg=True, agg_strength=0.3)
    runs = [(geometric, None), (krylov_w, None), (production, None)]
    if n_ranks >= 4 and n_ranks % 2 == 0:
        runs.append((production, (2, n_ranks // 2)))
    shapes = []
    for cfg, mesh_shape in runs:
        dist = DistributedStencilSolver(macro, cfg, comm,
                                        mesh_shape=mesh_shape)
        T = dist.to_std(dist.run())
        if not np.isfinite(T).all():
            raise FloatingPointError(f"dryrun: non-finite state ({cfg})")
        shapes.append(T.shape)
    return shapes


def bench_dist_rank(comm, spec: dict) -> list:
    """One rank of ``bench_dist``: each run of ``spec["runs"]`` in turn
    (``_bench_dist_run``), after the kernels are built on the card."""
    if comm.device.type == "cuda":
        # the builds stay out of setup_s
        K1.KERNEL.function(torch.float32)
        K2.KERNEL.function(torch.float32)
    out = []
    for run in spec["runs"]:
        out.append(_bench_dist_run(comm, run))
        if comm.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _windows(step, x0, n: int, reps: int, barrier):
    """(best seconds a call of step, the state after the last window, the
    seconds of all windows): ``reps`` eager windows of n chained calls from
    x0, each between two ``barrier()`` calls; CUDA events time a window on
    the card (one synchronise at its end), ``time.perf_counter`` on the
    CPU."""
    cuda = x0.device.type == "cuda"
    best, total, x = float("inf"), 0.0, x0
    for _ in range(reps):
        barrier()
        x = x0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                x = step(x)
            end.record()
            end.synchronize()
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                x = step(x)
            s = time.perf_counter() - t0
        barrier()
        best, total = min(best, s), total + s
    return best / n, x, total


def _bench_dist_run(comm, run: dict) -> dict:
    """One configuration of the distributed bench on this rank.

    ``run``: ``mesh`` (``structured.tri_mesh`` arguments; RCM-reordered
    first with ``rcm``), ``cfg`` (SemiConfig fields), ``mesh_shape``,
    ``unit`` ("cycle": level-0 cycles with the right-hand side of T0;
    "step": time steps), ``n`` calls a window, ``reps`` windows and
    ``model_at`` (a D for ``ghost_model_at``, or None).

    Builds the ``DistributedStencilSolver`` (``setup_s``), runs one untimed
    call, then times ``reps`` windows of n calls from T0 (``_windows``:
    rank 0's CUDA events between barriers), counting this rank's K1 and K2
    launches and, on rank 0, the host seconds of staging and of waiting
    over the windows.  Rank 0 then times the serial twin the same way
    while the other ranks wait at a barrier, and gives the largest
    distance between the gathered distributed state and the twin's after
    the same n calls from T0, relative to the twin's largest value.  Every
    rank returns its ``setup_s``, ``launches`` and ``sa_rows`` (it has rows
    of the sharded SA correction); rank 0 adds the rest."""
    dev = comm.device
    mesh = structured.tri_mesh(*run["mesh"])
    if run.get("rcm"):
        mesh = topology.rcm_reorder(mesh)
    cfg = config(run["cfg"])
    comm.barrier()
    t0 = time.perf_counter()
    dist = DistributedStencilSolver(mesh, cfg, comm,
                                    mesh_shape=run.get("mesh_shape"))
    _sync(dev)
    setup_s = time.perf_counter() - t0
    serial = dist.serial
    T0, S0 = dist.initial_condition(), to_t(serial.initial_condition())
    if run["unit"] == "cycle":
        b, sb = dist._rhs_t(T0), serial._rhs_t(S0)
        step = lambda x: dist._vcycle_t(0, x, b)
        serial_step = lambda x: serial._vcycle_t(0, x, sb)
    else:
        step, serial_step = dist.step, serial._step_t
    step(T0)
    _sync(dev)
    comm.barrier()
    K1.KERNEL.reset()
    K2.KERNEL.launches = 0
    comm.reset_stats()
    per, x, total = _windows(step, T0, run["n"], run["reps"], comm.barrier)
    out = dict(setup_s=setup_s, sa_rows=bool(dist.rowops()),
               launches={"k1_phase": K1.KERNEL.launches,
                         "k2_rowop": K2.KERNEL.launches})
    stats = dict(comm.stats)
    x_full = comm.all_gather(x, -1)
    if comm.rank == 0:
        print(f"[bench_dist] {run['name']}: ranks={comm.world} setup "
              f"{setup_s:.1f}s, {per * 1e3:.3f} ms a {run['unit']}",
              file=sys.stderr, flush=True)
        serial_step(S0)
        _sync(dev)
        serial_per, xs, _ = _windows(serial_step, S0, run["n"], run["reps"],
                                     lambda: None)
        out.update(
            dist_s=per, serial_s=serial_per,
            dist_vs_serial_rel=float((x_full - xs).abs().max()
                                     / xs.abs().max()),
            staging_share=stats["staging_s"] / total,
            wait_share=stats["wait_s"] / total,
            messages=stats["messages"], bytes=stats["bytes"],
            ghost_report=dist.ghost_report(), U=dist.U, U_loc=dist.U_loc,
            children=serial.ops[0].C,
            halo_window_W=max(ph.W for ph in dist._phases),
            amg_dist_engaged=dist._agg is not None,
            amg_tables_built=dist._agg_li is not None,
            ghost_model=(None if run.get("model_at") is None else
                         ghost_model_at(serial, cfg, run["model_at"])))
    comm.barrier()
    return out

"""The rank programs of ``--devices N`` (``cli_rank``) and of
``entry.dryrun_multichip`` (``dryrun_rank``), for ``comm.launch``.

They live here, not beside their callers: a spawned rank imports its
program by module and name, and multiprocessing does not import a
package's ``__main__`` (``python -m p_a_multigrids_tpu_torch``) in a
spawned process.
"""

from __future__ import annotations

import os

import numpy as np

from .. import __main__ as cli
from ..config import SemiConfig
from ..mesh import structured
from .stencil_solver import DistributedStencilSolver


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

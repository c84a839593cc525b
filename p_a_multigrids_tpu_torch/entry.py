"""Entry point of the port: one forward step of the flagship solver.

The counterpart of the JAX package's ``__graft_entry__.entry``: the same
small problem (``tri_mesh(4, 4, 0.25, 0.25)``, n_split 2, two levels,
dt 0.05, one V-cycle a step, float32), whose "forward step" is one
theta-implicit time step, the right-hand side and ``n_multigrid``
V-cycles.  On the card the cycle's smoothing phases run kernel K1.

    python -m p_a_multigrids_tpu_torch.entry [--device cpu]

prints the shape of one step's output.  ``dryrun_multichip(n)`` runs the
sharded step on n ranks (``parallel``).
"""

from __future__ import annotations

import argparse

import torch

from .config import SemiConfig
from .mesh import structured
from .models import semi as msemi
from .ops.fused import from_t, to_t


def small_solver(device, dtype: str = "float32") -> msemi.SemiSolver:
    """The entry's solver on ``device``."""
    mesh = structured.tri_mesh(4, 4, 0.25, 0.25)
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.05, ntime=1,
                     n_multigrid=1, dtype=dtype)
    return msemi.SemiSolver(msemi.build_problem(mesh, cfg), device)


def entry(device=None):
    """(step, (T0,)): one time step of the flagship solver, T (U, C, 3) ->
    T, and its initial state, on ``device`` (the card unless the caller
    asks for the CPU)."""
    solver = small_solver(torch.device("cuda" if device is None else device))
    T0 = solver.initial_condition()

    def step(T):
        T_t = to_t(T)
        b_t = solver._rhs_t(T_t)
        for _ in range(solver.cfg.n_multigrid):
            T_t = solver._vcycle_t(0, T_t, b_t)
        return from_t(T_t)

    return step, (T0,)


def dryrun_multichip(n_ranks: int, device=None) -> list:
    """The counterpart of the JAX package's ``__graft_entry__.
    dryrun_multichip``: the sharded solver step on ``n_ranks`` ranks of
    ``parallel.comm.launch`` on ``device`` (the card unless the caller asks
    for the CPU): RCM-banded macro partitioning, ring halo exchanges (k-hop
    where a halo is wider than a rank's block), K1 phases on deep-ghost
    extended domains, the sharded SA correction through K2, Krylov dots
    summed over the ranks, macro-local transfers and the replicated dense
    coarsest solve.  Three configurations run (geometric, Krylov W-cycle,
    the production amg), and with four or more ranks, an even number, the
    production one again with mesh_shape (2, n/2).  Returns rank 0's
    final state shapes."""
    from .parallel import comm, programs

    return comm.launch(programs.dryrun_rank, n_ranks,
                       torch.device("cuda" if device is None else device),
                       args=(n_ranks,))[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="p_a_multigrids_tpu_torch.entry")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    step, (T0,) = entry(args.device)
    print(tuple(step(T0).shape))


if __name__ == "__main__":
    main()

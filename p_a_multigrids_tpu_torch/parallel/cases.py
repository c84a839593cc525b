"""Rank programs that check the distributed solvers: ``run_cases(comm,
cases)`` runs a list of case specifications on every rank of a
``comm.launch`` pool and returns, on rank 0, each case's result by its
"id" (None on the other ranks).  The CPU tests (``tests/
test_torch_parallel.py``) launch one pool per world size with every case
of that size; ``fail_on`` checks that a failing rank fails the launch.

The module serves the tests only.  It lives in the package because a
spawned rank imports its program by module name, and the tests directory
is not a package a rank could import from.

Case kinds (a dict with "id" and "kind"):

- ``ring``: ``comm.ring_halo`` of each rank's block of a seeded global
  array (``U_loc``, ``H``, ``seed``): the largest difference from the
  global array's slices, over the positions inside it;
- ``stencil``: a ``DistributedStencilSolver`` on ``structured.tri_mesh(*
  mesh)`` with ``SemiConfig(**cfg)`` (and ``mesh_shape``), ``ntime`` steps
  from the initial condition, or from the checkpoint ``load``; optionally
  saved to ``save``; with ``serial`` the serial twin's steps from the same
  state on rank 0, with the ghost report, the Krylov counts and the K1
  and K2 launches of the distributed steps (0 on the CPU);
- ``semi``: a ``DistributedSemiSolver``, ``ntime`` steps;
- ``imports``: the modules of jax or of the JAX package the ranks loaded
  (none: a rank runs the port alone).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import Physics, SemiConfig
from ..mesh import structured
from ..ops import phase as K1
from ..ops import spmv as K2
from ..ops.fused import from_t, to_t


def config(spec: dict) -> SemiConfig:
    """SemiConfig from a dict of its fields (``physics`` a dict too)."""
    spec = dict(spec)
    if "physics" in spec:
        spec["physics"] = Physics(**spec["physics"])
    return SemiConfig(**spec)


def _ring(comm, case):
    U_loc, H = case["U_loc"], case["H"]
    U = U_loc * comm.world
    g = np.random.default_rng(case["seed"]).normal(size=(2, 3, U))
    lo, hi = comm.rank * U_loc, (comm.rank + 1) * U_loc
    x = torch.as_tensor(g[..., lo:hi], device=comm.device)
    left, right = comm.ring_halo(x, H)
    if left.shape[-1] != H or right.shape[-1] != H:
        raise ValueError(f"ring_halo widths {left.shape}, {right.shape}")
    pos_l, pos_r = np.arange(lo - H, lo), np.arange(hi, hi + H)
    ok_l, ok_r = pos_l >= 0, pos_r < U
    err = max(float(np.abs(left.cpu().numpy()[..., ok_l]
                           - g[..., pos_l[ok_l]]).max(initial=0.0)),
              float(np.abs(right.cpu().numpy()[..., ok_r]
                           - g[..., pos_r[ok_r]]).max(initial=0.0)))
    # every rank's error, so that rank 0 reports the worst
    return float(comm.all_gather(torch.tensor([err], dtype=torch.float64,
                                              device=comm.device)).max())


def _stencil(comm, case):
    from .stencil_solver import DistributedStencilSolver

    mesh = structured.tri_mesh(*case["mesh"])
    dist = DistributedStencilSolver(mesh, config(case["cfg"]), comm,
                                    mesh_shape=case.get("mesh_shape"))
    K1.KERNEL.reset()
    K2.KERNEL.launches = 0
    step0 = 0
    if case.get("load"):
        T_t, step0 = dist.load_checkpoint(case["load"])
    else:
        T_t = dist.initial_condition()
    T0_std = dist.to_std(T_t)
    T_t = dist.run(T_t, case["ntime"])
    if case.get("save"):
        dist.save_checkpoint(case["save"], T_t, step0 + case["ntime"])
    out = dict(std=dist.to_std(T_t), ghost=dist.ghost_report(),
               krylov_iters=list(dist.krylov_iters), step=step0,
               n_active=dist.n_active, U=dist.U, k1=K1.KERNEL.launches,
               k2=K2.KERNEL.launches)
    if case.get("serial") and comm.rank == 0:
        # the serial twin from the same state, on the same mesh
        serial = dist.serial
        full = np.zeros((dist.U,) + T0_std.shape[1:], T0_std.dtype)
        full[: dist.n_active] = T0_std
        S = to_t(torch.as_tensor(full, device=dist.device))
        for _ in range(case["ntime"]):
            S = serial._step_t(S)
        out["serial"] = from_t(S)[: dist.n_active].cpu().numpy()
        out["serial_krylov_iters"] = list(serial.krylov_iters)
    return out


def _semi(comm, case):
    from .solver import DistributedSemiSolver

    dist = DistributedSemiSolver(structured.tri_mesh(*case["mesh"]),
                                 config(case["cfg"]), comm)
    T = dist.run(ntime=case["ntime"])
    return dict(active=dist.active(T), n_active=dist.part.n_active)


def _imports(comm, case):
    """How many modules of jax or of the JAX package the ranks loaded
    (most of any rank), and rank 0's names of them."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "p_a_multigrids_tpu"))
    most = int(comm.all_gather(torch.tensor([len(bad)],
                                            device=comm.device)).max())
    return dict(most=most, names=bad)


_KINDS = {"ring": _ring, "stencil": _stencil, "semi": _semi,
          "imports": _imports}


def run_cases(comm, cases: list) -> dict | None:
    """Every case on this rank; rank 0 returns {id: result}."""
    out = {case["id"]: _KINDS[case["kind"]](comm, case) for case in cases}
    return out if comm.rank == 0 else None


def fail_on(comm, rank: int):
    """Rank ``rank`` raises while the others wait in a collective."""
    if comm.rank == rank:
        raise RuntimeError(f"rank {rank} failed on purpose")
    comm.all_reduce_sum(torch.ones(1, device=comm.device))

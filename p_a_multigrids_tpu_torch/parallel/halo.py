"""Halo exchange plan of the general distributed solver: the distributed
form of the flat neighbour gather (``build_halo_plan`` is a numpy copy of
the JAX package's ``parallel/halo.py`` and gives the same tables, bit for
bit).

  1. each rank packs the face-strip elements that any other rank reads
     (its export buffer),
  2. one ``all_gather`` moves every export buffer,
  3. a static (rank, slot) gather scatters the received values into the
     (U_loc, C, 3, ...) layout that ``models.semi.flat_gather`` produces.

All indices are computed once at setup; the run-time cost is one
collective whose payload is the union of the partition-boundary strips.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class HaloPlan:
    """Per-rank static tables, stacked on a leading rank axis."""
    export_idx: np.ndarray   # (D, S) int32: local-flat indices to export
    is_remote: np.ndarray    # (D, U_loc, C, 3) bool
    local_idx: np.ndarray    # (D, U_loc, C, 3) int32 into local flat
    src_dev: np.ndarray      # (D, U_loc, C, 3) int32
    src_slot: np.ndarray     # (D, U_loc, C, 3) int32
    n_devices: int
    slots: int               # S


def build_halo_plan(neigh_elem: np.ndarray, n_devices: int) -> HaloPlan:
    """Build the exchange plan from the global flat neighbor table.

    Args:
      neigh_elem: (U, C, 3) global flat indices (u*C+c), -1 = boundary
      n_devices: number of contiguous equal blocks over the macro axis
    """
    U, C, nface = neigh_elem.shape
    if U % n_devices:
        raise ValueError("partition the mesh to equal blocks first")
    U_loc = U // n_devices
    block = U_loc * C

    owner = np.where(neigh_elem >= 0, neigh_elem // block, -1)

    # exports[o] = sorted global flats owned by o that any other rank reads
    exports: list[set] = [set() for _ in range(n_devices)]
    for d in range(n_devices):
        blk = neigh_elem[d * U_loc:(d + 1) * U_loc]
        own = owner[d * U_loc:(d + 1) * U_loc]
        remote = blk[(own >= 0) & (own != d)]
        for g in np.unique(remote):
            exports[int(g) // block].add(int(g))
    export_lists = [sorted(s) for s in exports]
    S = max(1, max(len(s) for s in export_lists))
    export_idx = np.zeros((n_devices, S), np.int32)
    slot_of: dict[int, tuple[int, int]] = {}
    for o, lst in enumerate(export_lists):
        for slot, g in enumerate(lst):
            export_idx[o, slot] = g - o * block          # local flat index
            slot_of[g] = (o, slot)

    is_remote = np.zeros((n_devices, U_loc, C, 3), bool)
    local_idx = np.zeros((n_devices, U_loc, C, 3), np.int32)
    src_dev = np.zeros((n_devices, U_loc, C, 3), np.int32)
    src_slot = np.zeros((n_devices, U_loc, C, 3), np.int32)
    self_flat = (np.arange(U_loc * C, dtype=np.int32)
                 .reshape(U_loc, C, 1))
    for d in range(n_devices):
        blk = neigh_elem[d * U_loc:(d + 1) * U_loc]      # (U_loc, C, 3)
        own = owner[d * U_loc:(d + 1) * U_loc]
        lidx = np.where(own == d, blk - d * block, 0).astype(np.int32)
        lidx = np.where(blk < 0, self_flat, lidx)        # boundary -> self
        rem = (own >= 0) & (own != d)
        is_remote[d] = rem
        local_idx[d] = np.where(rem, 0, lidx)
        for (u, c, f) in zip(*np.nonzero(rem)):
            o, slot = slot_of[int(blk[u, c, f])]
            src_dev[d, u, c, f] = o
            src_slot[d, u, c, f] = slot
    return HaloPlan(export_idx=export_idx, is_remote=is_remote,
                    local_idx=local_idx, src_dev=src_dev, src_slot=src_slot,
                    n_devices=n_devices, slots=S)


def make_gather(plan: HaloPlan, comm, device):
    """Rank-local gather with the ``flat_gather`` contract, over
    ``comm.all_gather``: gather(L, X) maps this rank's (U_loc, C, D...) to
    (U_loc, C, 3, D...), the values across each face."""
    d = comm.rank
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    export_idx, local_idx = t(plan.export_idx[d]), t(plan.local_idx[d])
    src_dev, src_slot = t(plan.src_dev[d]), t(plan.src_slot[d])
    is_remote = torch.as_tensor(plan.is_remote[d], device=device)

    def gather(L, X):
        U_loc, C = X.shape[:2]
        trail = X.shape[2:]
        flat = X.reshape(U_loc * C, *trail)
        gathered = comm.all_gather(flat[export_idx][None], 0)  # (D, S, ...)
        remote = gathered[src_dev, src_slot]             # (U_loc, C, 3, ...)
        mask = is_remote.reshape(is_remote.shape + (1,) * len(trail))
        return torch.where(mask, remote, flat[local_idx])

    return gather

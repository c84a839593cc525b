"""Macro-element partitioning for multi-rank runs (numpy copy of the JAX
package's ``parallel/partition.py``; the same orders and meshes, bit for
bit).

A BFS ordering over the macro adjacency graph yields locality-preserving
contiguous blocks, one per rank, so cross-rank faces (the halo traffic) are
few and ownership is computable as ``element // block_size``.  Padding
appends isolated dummy elements until every rank holds the same number.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..mesh.topology import MacroMesh, reorder_elements


def bfs_order(neig: np.ndarray) -> np.ndarray:
    """Breadth-first ordering of the macro adjacency graph (all components).

    Returns order (U,) such that order[k] is the k-th element visited.
    """
    U = neig.shape[0]
    visited = np.zeros(U, bool)
    order = np.empty(U, np.int64)
    pos = 0
    for seed in range(U):
        if visited[seed]:
            continue
        queue = [seed]
        visited[seed] = True
        while queue:
            e = queue.pop(0)
            order[pos] = e
            pos += 1
            for f in range(3):
                n = neig[e, f]
                if n >= 0 and not visited[n]:
                    visited[n] = True
                    queue.append(n)
    if pos != U:
        raise ValueError(f"bfs_order visited {pos} of {U} elements")
    return order


def permute_mesh(mesh: MacroMesh, order: np.ndarray) -> MacroMesh:
    """Relabel elements so element k is old element order[k]."""
    return reorder_elements(mesh, order)


def pad_mesh(mesh: MacroMesh, multiple: int) -> tuple[MacroMesh, int]:
    """Append isolated dummy elements until U is a multiple of `multiple`.

    Dummies are translated copies of element 0 placed far outside the
    domain with no neighbors; they solve their own decoupled (Dirichlet-0)
    systems and never touch real elements.  Returns (padded mesh,
    n_active).
    """
    U = mesh.num_elements
    pad = (-U) % multiple
    if pad == 0:
        return mesh, U
    span = np.abs(mesh.X).max() + 1.0
    Xp = [mesh.X]
    for i in range(pad):
        Xi = mesh.X[0:1].copy()
        Xi[:, 0, :] += 17.0 * span * (i + 1)
        Xp.append(Xi)
    X = np.concatenate(Xp, axis=0)
    neig = np.concatenate([mesh.neig, np.full((pad, 3), -1, np.int32)])
    nf = np.concatenate([mesh.neigh_face, np.full((pad, 3), -1, np.int32)])
    df = np.concatenate([mesh.dir_flag, np.zeros((pad, 3), bool)])
    tri = np.concatenate([mesh.tri, np.full((pad, 3), -1, np.int32)])
    rid = np.concatenate([mesh.region_id, np.zeros(pad, np.int32)])
    return MacroMesh(X=X, tri=tri, neig=neig, neigh_face=nf, dir_flag=df,
                     region_id=rid), U


@dataclasses.dataclass
class Partitioned:
    mesh: MacroMesh
    n_active: int
    n_parts: int

    @property
    def block(self) -> int:
        return self.mesh.num_elements // self.n_parts


def partition_mesh(mesh: MacroMesh, n_parts: int) -> Partitioned:
    """BFS-order, then pad to equal contiguous blocks per rank."""
    mesh = permute_mesh(mesh, bfs_order(mesh.neig))
    mesh, n_active = pad_mesh(mesh, n_parts)
    return Partitioned(mesh=mesh, n_active=n_active, n_parts=n_parts)


def cut_fraction(mesh: MacroMesh, n_parts: int) -> float:
    """Fraction of interior macro faces crossing a partition boundary."""
    U = mesh.num_elements
    block = U // n_parts
    own = np.arange(U) // block
    e, f = np.nonzero(mesh.neig >= 0)
    other = own[mesh.neig[e, f]]
    return float((own[e] != other).mean())

"""Macro-mesh neighbor topology by sorted-edge hashing, O(E) (port of the
JAX package's ``mesh/topology.py``).  ``build_macro_mesh`` runs the C++
search (``utils.native.neighbor_topology``); ``_neighbor_topology_py`` is
its plain Python version, which the tests hold it to.

Face convention (MACRO_FACE_NODES): face 0 = edge(node0, node2), face 1 =
edge(node0, node1), face 2 = edge(node1, node2).  ``dir_flag[e, f]`` is
True when element e and its neighbor traverse the shared edge in the same
direction under their own local face orderings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import native
from .splitting import MACRO_FACE_NODES


@dataclasses.dataclass
class MacroMesh:
    """Unstructured macro-triangle mesh with neighbor topology."""
    X: np.ndarray            # (U, 2, 3) vertex coordinates per element
    tri: np.ndarray          # (U, 3) int32 global vertex ids
    neig: np.ndarray         # (U, 3) int32 neighbor element per face, -1=bnd
    neigh_face: np.ndarray   # (U, 3) int32 the neighbor's face id, -1=bnd
    dir_flag: np.ndarray     # (U, 3) bool same-direction traversal
    region_id: np.ndarray    # (U,) int32

    @property
    def num_elements(self) -> int:
        return self.X.shape[0]


def dedupe_vertices(vertices: np.ndarray, triangles: np.ndarray,
                    tol: float = 1e-10):
    """Canonicalize vertex ids so coincident points share one id.

    Returns (canon_tri, canon_vertices).
    """
    scale = max(np.abs(vertices).max(), 1.0)
    q = np.round(vertices / (scale * tol)).astype(np.int64)
    _, rep, canon = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    return canon[triangles].astype(np.int32), vertices[rep]


def build_macro_mesh(vertices: np.ndarray, triangles: np.ndarray,
                     region_id: np.ndarray | None = None) -> MacroMesh:
    """Build neighbor topology from shared vertex ids.

    Args:
      vertices: (nnodes, >=2) coordinates
      triangles: (U, 3) 0-based vertex ids
      region_id: optional (U,)
    """
    triangles, vertices = dedupe_vertices(vertices, triangles)
    U = triangles.shape[0]
    if region_id is None:
        region_id = np.zeros((U,), np.int32)
    neig, neigh_face, dir_flag = native.neighbor_topology(triangles)
    X = np.transpose(vertices[triangles][:, :, :2], (0, 2, 1)).astype(
        np.float64)   # (U, 2, 3)
    return MacroMesh(X=X, tri=triangles, neig=neig, neigh_face=neigh_face,
                     dir_flag=dir_flag, region_id=region_id.astype(np.int32))


def _neighbor_topology_py(triangles: np.ndarray):
    U = triangles.shape[0]
    neig = np.full((U, 3), -1, np.int32)
    neigh_face = np.full((U, 3), -1, np.int32)
    dir_flag = np.zeros((U, 3), bool)

    edge_map: dict[tuple[int, int], tuple[int, int, int]] = {}
    for e in range(U):
        for f in range(3):
            a = int(triangles[e, MACRO_FACE_NODES[f, 0]])
            b = int(triangles[e, MACRO_FACE_NODES[f, 1]])
            key = (a, b) if a < b else (b, a)
            if key in edge_map:
                e2, f2, a2 = edge_map.pop(key)
                neig[e, f] = e2
                neig[e2, f2] = e
                neigh_face[e, f] = f2
                neigh_face[e2, f2] = f
                same = a == a2
                dir_flag[e, f] = same
                dir_flag[e2, f2] = same
            else:
                edge_map[key] = (e, f, a)
    return neig, neigh_face, dir_flag


def from_msh(path: str) -> MacroMesh:
    """Macro mesh of a gmsh 2.x ASCII file (``mesh.gmsh.read_msh``)."""
    from . import gmsh
    raw = gmsh.read_msh(path)
    return build_macro_mesh(raw.vertices, raw.triangles, raw.region_id)


def reorder_elements(mesh: MacroMesh, perm: np.ndarray) -> MacroMesh:
    """Relabel macro elements so new element i is old element perm[i]."""
    perm = np.asarray(perm)
    inv = np.empty(mesh.num_elements, np.int32)
    inv[perm] = np.arange(mesh.num_elements, dtype=np.int32)
    neig = mesh.neig[perm]
    neig = np.where(neig >= 0, inv[np.maximum(neig, 0)], -1).astype(np.int32)
    return MacroMesh(X=mesh.X[perm], tri=mesh.tri[perm], neig=neig,
                     neigh_face=mesh.neigh_face[perm],
                     dir_flag=mesh.dir_flag[perm],
                     region_id=mesh.region_id[perm])


def rcm_order(mesh: MacroMesh) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of the macro adjacency graph."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    U = mesh.num_elements
    rows = np.repeat(np.arange(U), 3)
    cols = mesh.neig.ravel()
    keep = cols >= 0
    A = csr_matrix((np.ones(keep.sum()), (rows[keep], cols[keep])),
                   shape=(U, U))
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      np.int32)


def rcm_reorder(mesh: MacroMesh) -> MacroMesh:
    """Reorder a mesh by RCM (see rcm_order)."""
    return reorder_elements(mesh, rcm_order(mesh))

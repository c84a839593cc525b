"""Flat DG adjacency for the semi-structured hierarchy (copy of the JAX
package's ``mesh/semi.py``).

Every level is described by static gather tables over the flat child axis
``e = u * C + c``:

  neigh_elem[u, c, f]      flat index of the element across face f
                           (intra-macro, cross-macro, or -1 on the domain
                           boundary)
  neigh_perm[u, c, f, k]   the neighbor's local node id that coincides with
                           my k-th face node
  bc_*                     domain-boundary faces with the coordinates of
                           their edge endpoints, for Dirichlet evaluation
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import splitting
from .topology import MacroMesh


@dataclasses.dataclass
class SemiLevel:
    n: int                      # split depth at this level
    updown: np.ndarray          # (C,) int32 ±1
    neigh_elem: np.ndarray      # (U, C, 3) int32 flat (u*C+c), -1 = boundary
    neigh_perm: np.ndarray      # (U, C, 3, 2) int32, 0 at boundary faces
    bc_elem: np.ndarray         # (nb,) int32 flat element with boundary face
    bc_face: np.ndarray         # (nb,) int32 its child-face id
    bc_coords: np.ndarray       # (nb, 2, 2) endpoint coords (node k, dim)

    @property
    def num_children(self) -> int:
        return 4 ** self.n


@dataclasses.dataclass
class SemiGrid:
    macro: MacroMesh
    n_split: int
    levels: list[SemiLevel]     # index 0 = finest (n = n_split)

    @property
    def num_macro(self):
        return self.macro.num_elements


def _cross_macro_tables(macro: MacroMesh, n: int):
    """Match boundary-strip children across macro faces by coordinates,
    batched over the macro elements of each (my face, neighbor face)
    case."""
    U = macro.num_elements
    C = splitting.num_children(n)
    m = 2 ** n
    coords = splitting.child_coords(macro.X, n)        # (U, C, 2, 3)
    strip_elems, strip_cface, _ = splitting.boundary_strips(n)

    neigh = splitting.child_neighbors(n)               # (C, 3)
    perm_in = splitting.child_neighbor_nodeperm(n)     # (C, 3, 2)

    neigh_elem = np.zeros((U, C, 3), np.int64)
    base = np.arange(U, dtype=np.int64)[:, None, None] * C
    neigh_elem[:] = np.where(neigh[None] >= 0, base + neigh[None], -1)
    neigh_perm = np.broadcast_to(
        np.where(perm_in < 0, 0, perm_in)[None], (U, C, 3, 2)).copy()

    bc_elem, bc_face, bc_coords = [], [], []
    fn = splitting.CHILD_FACE_NODES

    e1 = macro.X[:, :, 1] - macro.X[:, :, 0]           # (U, 2)
    e2v = macro.X[:, :, 2] - macro.X[:, :, 0]
    h = np.sqrt(np.abs(e1[:, 0] * e2v[:, 1] - e1[:, 1] * e2v[:, 0])).mean()
    tol = 1e-6 * h / m

    for mf in range(3):
        cf = int(strip_cface[mf])
        a, b = fn[cf]
        mine = strip_elems[mf]                         # (m,)
        my_pts = coords[:, mine][:, :, :, [a, b]]      # (U, m, dim, node)
        my_mid = my_pts.mean(axis=3)                   # (U, m, 2)
        v_all = macro.neig[:, mf]                      # (U,)

        bu = np.nonzero(v_all < 0)[0]
        if len(bu):
            bc_elem.append((bu[:, None] * C + mine[None, :]).ravel())
            bc_face.append(np.full(len(bu) * m, cf, np.int32))
            # (node, dim) per face, strip-ordered within each macro
            bc_coords.append(
                my_pts[bu].transpose(0, 1, 3, 2).reshape(-1, 2, 2))

        for mf2 in range(3):
            sel = np.nonzero((v_all >= 0)
                             & (macro.neigh_face[:, mf] == mf2))[0]
            if not len(sel):
                continue
            vv = v_all[sel]                            # (G,)
            cf2 = int(strip_cface[mf2])
            theirs = strip_elems[mf2]                  # (m,)
            a2, b2 = fn[cf2]
            their_pts = coords[vv][:, theirs][:, :, :, [a2, b2]]
            their_mid = their_pts.mean(axis=3)         # (G, m, 2)
            d = np.linalg.norm(
                my_mid[sel][:, :, None] - their_mid[:, None], axis=-1)
            match = np.argmin(d, axis=2)               # (G, m)
            assert (np.take_along_axis(d, match[:, :, None], axis=2)
                    < tol).all(), f"cross-macro strip mismatch mf={mf}"
            el2 = theirs[match]                        # (G, m)
            neigh_elem[sel[:, None], mine[None, :], cf] = \
                vv[:, None] * C + el2
            nbc = coords[vv[:, None], el2]             # (G, m, 2, 3)
            for kk, node in enumerate((a, b)):
                p = coords[sel][:, mine][:, :, :, node]   # (G, m, 2)
                dd = np.linalg.norm(nbc - p[..., None], axis=2)  # (G, m, 3)
                j = np.argmin(dd, axis=2)
                assert (np.take_along_axis(dd, j[:, :, None], axis=2)
                        < tol).all()
                neigh_perm[sel[:, None], mine[None, :], cf, kk] = j

    cat = lambda lst, dt_: (np.concatenate(lst).astype(dt_) if lst
                            else np.zeros((0,), dt_))
    bc_coords_arr = (np.concatenate(bc_coords) if bc_coords
                     else np.zeros((0, 2, 2)))
    return (neigh_elem.astype(np.int32), neigh_perm.astype(np.int32),
            cat(bc_elem, np.int32), cat(bc_face, np.int32),
            bc_coords_arr.astype(np.float64))


def build_level(macro: MacroMesh, n: int) -> SemiLevel:
    _, updown = splitting.child_lattice(n)
    neigh_elem, neigh_perm, bc_elem, bc_face, bc_coords = (
        _cross_macro_tables(macro, n))
    return SemiLevel(n=n, updown=updown, neigh_elem=neigh_elem,
                     neigh_perm=neigh_perm, bc_elem=bc_elem, bc_face=bc_face,
                     bc_coords=bc_coords)


def build_grid(macro: MacroMesh, n_split: int,
               multi_levels: int = 1) -> SemiGrid:
    """Build the level hierarchy: level i has split depth n_split - i
    (depth 0, plain P1 DG on the macro mesh, is a valid coarsest level)."""
    if multi_levels > n_split + 1:
        raise ValueError(
            f"multi_levels={multi_levels} exceeds n_split+1={n_split + 1}")
    levels = [build_level(macro, n_split - i) for i in range(multi_levels)]
    return SemiGrid(macro=macro, n_split=n_split, levels=levels)

"""Semi-structured splitting: exact integer-lattice tables for the 4**n
child hierarchy inside each macro triangle (copy of the JAX package's
``mesh/splitting.py``).

Lattice convention: a macro triangle with vertices (X1, X2, X3) is split
``n`` times; lattice point ``(i, j)`` is the physical point
``X3 + i*(X1-X3)/2**n + j*(X2-X3)/2**n`` with ``i, j >= 0, i+j <= 2**n``.
Children are ordered row-major (row 1 is the strip along the (X1, X3) edge;
within a row, children alternate up/down starting with an up triangle).
"""

from __future__ import annotations

import functools

import numpy as np

# child-local faces: face f = edge (a, b), 0-based volume node ids
CHILD_FACE_NODES = np.asarray([[0, 2], [2, 1], [1, 0]], np.int32)
# macro faces as discovered by the neighbor search
MACRO_FACE_NODES = np.asarray([[0, 2], [0, 1], [1, 2]], np.int32)
# child face -> macro face it lies on when on the macro boundary
CHILD2MACRO_FACE = np.asarray([0, 2, 1], np.int32)


def num_children(n: int) -> int:
    return 4 ** n


@functools.lru_cache(maxsize=None)
def child_lattice(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Vertex lattice coordinates (C, 3, 2) and orientation (C,) (+1 up,
    -1 down) of every child."""
    C = num_children(n)
    verts = np.zeros((C, 3, 2), np.int32)
    updown = np.zeros((C,), np.int32)
    e = 0
    width = 2 ** (n + 1) - 1
    for r in range(1, 2 ** n + 1):          # row (1-based)
        for p in range(1, width + 1):       # position within row
            if p % 2 == 1:                  # up triangle
                q = p // 2
                verts[e, 0] = (q + 1, r - 1)
                verts[e, 1] = (q, r)
                verts[e, 2] = (q, r - 1)
                updown[e] = 1
            else:                           # down triangle
                q = p // 2
                verts[e, 0] = (q - 1, r)
                verts[e, 1] = (q, r - 1)
                verts[e, 2] = (q, r)
                updown[e] = -1
            e += 1
        width -= 2
    assert e == C
    return verts, updown


@functools.lru_cache(maxsize=None)
def child_neighbors(n: int) -> np.ndarray:
    """Intra-macro neighbor table (C, 3) int32: the child across each child
    face, or -1 where the face lies on the macro boundary."""
    verts, _ = child_lattice(n)
    C = verts.shape[0]
    edge_owner: dict[frozenset, list[tuple[int, int]]] = {}
    for e in range(C):
        for f in range(3):
            a, b = CHILD_FACE_NODES[f]
            key = frozenset((tuple(verts[e, a]), tuple(verts[e, b])))
            edge_owner.setdefault(key, []).append((e, f))
    neigh = np.full((C, 3), -1, np.int32)
    for owners in edge_owner.values():
        if len(owners) == 2:
            (e1, f1), (e2, f2) = owners
            neigh[e1, f1] = e2
            neigh[e2, f2] = e1
    return neigh


@functools.lru_cache(maxsize=None)
def child_neighbor_nodeperm(n: int) -> np.ndarray:
    """perm (C, 3, 2) int32: for child c, face f with nodes (a, b), the
    intra-macro neighbor's local node ids at the positions of my nodes a and
    b.  -1 where the face is on the macro boundary."""
    verts, _ = child_lattice(n)
    neigh = child_neighbors(n)
    C = verts.shape[0]
    perm = np.full((C, 3, 2), -1, np.int32)
    for e in range(C):
        for f in range(3):
            e2 = neigh[e, f]
            if e2 < 0:
                continue
            for k, me in enumerate(CHILD_FACE_NODES[f]):
                for l in range(3):
                    if (verts[e, me] == verts[e2, l]).all():
                        perm[e, f, k] = l
                        break
    return perm


@functools.lru_cache(maxsize=None)
def boundary_strips(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Children on each macro face.

    Returns:
      strip_elems: (3, 2**n) int32 — child on macro face mf at slot k; slots
        run along MACRO_FACE_NODES[mf][0] -> MACRO_FACE_NODES[mf][1].
      strip_cface: (3,) int32 — the child face facing out of macro face mf.
      slot_of:     (C, 3) int32 — slot of (child, child-face) boundary
        pairs, -1 elsewhere.
    """
    verts, _ = child_lattice(n)
    neigh = child_neighbors(n)
    C = verts.shape[0]
    m = 2 ** n
    strip_elems = np.full((3, m), -1, np.int32)
    slot_of = np.full((C, 3), -1, np.int32)
    for e in range(C):
        for f in range(3):
            if neigh[e, f] >= 0:
                continue
            a, b = CHILD_FACE_NODES[f]
            va, vb = verts[e, a], verts[e, b]
            mf = int(CHILD2MACRO_FACE[f])
            if mf == 0:        # j == 0 edge, from X1 (m,0) to X3 (0,0)
                assert va[1] == 0 and vb[1] == 0
                slot = m - 1 - min(va[0], vb[0])
            elif mf == 1:      # i+j == m edge, from X1 (m,0) to X2 (0,m)
                assert va.sum() == m and vb.sum() == m
                slot = min(va[1], vb[1])
            else:              # i == 0 edge, from X2 (0,m) to X3 (0,0)
                assert va[0] == 0 and vb[0] == 0
                slot = m - 1 - min(va[1], vb[1])
            strip_elems[mf, slot] = e
            slot_of[e, f] = slot
    assert (strip_elems >= 0).all()
    strip_cface = np.argsort(CHILD2MACRO_FACE).astype(np.int32)
    return strip_elems, strip_cface, slot_of


@functools.lru_cache(maxsize=None)
def element_conversion(n_coarse: int) -> np.ndarray:
    """Children at depth n_coarse+1 of each child at depth n_coarse:
    (C_coarse, 4) int32, the three corner children (at coarse nodes 1, 2,
    3) then the central opposite-orientation child."""
    cv, cupd = child_lattice(n_coarse)
    fv, fupd = child_lattice(n_coarse + 1)
    findex = {
        (frozenset(map(tuple, fv[e])), int(fupd[e])): e
        for e in range(fv.shape[0])
    }
    Cc = cv.shape[0]
    fine = np.zeros((Cc, 4), np.int32)
    for e in range(Cc):
        v = cv[e] * 2                      # coarse verts in fine lattice units
        mids = {
            (0, 1): (v[0] + v[1]) // 2,
            (1, 2): (v[1] + v[2]) // 2,
            (0, 2): (v[0] + v[2]) // 2,
        }
        ud = int(cupd[e])
        for k in range(3):                 # corner child at coarse node k
            others = [m for pair, m in mids.items() if k in pair]
            tri = frozenset([tuple(v[k])] + [tuple(m) for m in others])
            fine[e, k] = findex[(tri, ud)]
        tri = frozenset(tuple(m) for m in mids.values())
        fine[e, 3] = findex[(tri, -ud)]
    return fine


def child_coords(X_macro: np.ndarray, n: int) -> np.ndarray:
    """Physical node coordinates (U, C, 2, 3) of every child, from the macro
    vertex coordinates X_macro (U, 2, 3)."""
    verts, _ = child_lattice(n)                      # (C, 3, 2)
    m = float(2 ** n)
    X3 = X_macro[:, :, 2]                            # (U, 2)
    v1 = (X_macro[:, :, 0] - X3) / m                 # (U, 2)
    v2 = (X_macro[:, :, 1] - X3) / m
    lat = verts.astype(np.float64)                   # (C, 3, 2)
    out = (X3[:, None, :, None]
           + np.einsum("cl,ud->ucdl", lat[:, :, 0], v1)
           + np.einsum("cl,ud->ucdl", lat[:, :, 1], v2))
    return out

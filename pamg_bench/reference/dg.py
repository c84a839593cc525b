"""Plain DG P1 assembly of the semi-structured theta-scheme system, in
NumPy float64, from the macro mesh and the configuration alone.

Nothing here imports the measured program or the JAX package.  The only
conventions shared with them are the input formats:

- the macro mesh of ``structured_macro_X`` (a frozen copy of the element
  and node order of ``mesh/structured.tri_mesh`` in both packages);
- the (U, C, 3) layout of a state: macro u, child c in the order of
  ``child_lattice`` (a frozen copy of ``mesh/splitting.child_lattice`` and
  ``child_coords`` of the JAX package), local node i.  The degree of
  freedom of (u, c, i) is 3 (u C + c) + i.

Everything else is worked out from the child triangles' coordinates: the
neighbours by matching edge end points, the normals, the face integrals
(exact closed forms for P1 traces) and the symmetric interior penalty
terms, with the penalty max(|F| / |E|) over the two sides, times 2**level
on coarse levels, and Nitsche's weak Dirichlet condition with the
manufactured g = sin(x + y).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

# local edges (node a, node b) of a child triangle; any labelling serves,
# since neighbours are matched by coordinates
EDGES = np.array([[0, 1], [1, 2], [2, 0]])


def structured_macro_X(rows: int, cols: int, dx: float, dy: float
                       ) -> np.ndarray:
    """(U, 2, 3) macro vertex coordinates of ``tri_mesh(rows, cols, dx,
    dy)``: each dx x dy cell, row-major from the origin, split into an "up"
    triangle (i+1, j), (i, j+1), (i, j) and a "down" one (i, j+1),
    (i+1, j), (i+1, j+1)."""
    j, i = np.meshgrid(np.arange(cols), np.arange(rows), indexing="ij")
    i, j = i.ravel(), j.ravel()
    up = [(i + 1, j), (i, j + 1), (i, j)]
    down = [(i, j + 1), (i + 1, j), (i + 1, j + 1)]

    def tri(nodes):                                       # (cells, 2, 3)
        return np.stack([np.stack([a * dx, b * dy], axis=1)
                         for a, b in nodes], axis=-1)

    return np.stack([tri(up), tri(down)], axis=1).reshape(-1, 2, 3).astype(
        np.float64)


def child_lattice(n: int) -> np.ndarray:
    """Lattice coordinates (C, 3, 2) of the children of a macro split n
    times, row by row, alternating up and down triangles."""
    verts = []
    width = 2 ** (n + 1) - 1
    for r in range(1, 2 ** n + 1):
        for p in range(1, width + 1):
            q = p // 2
            if p % 2:
                verts.append([(q + 1, r - 1), (q, r), (q, r - 1)])
            else:
                verts.append([(q - 1, r), (q, r - 1), (q, r)])
        width -= 2
    return np.asarray(verts, np.float64)


def child_coords(X: np.ndarray, n: int) -> np.ndarray:
    """(U, C, 2, 3) node coordinates of every child of the macros X."""
    lat = child_lattice(n)
    m = float(2 ** n)
    X3 = X[:, :, 2]
    v1 = (X[:, :, 0] - X3) / m
    v2 = (X[:, :, 1] - X3) / m
    return (X3[:, None, :, None]
            + np.einsum("cl,ud->ucdl", lat[:, :, 0], v1)
            + np.einsum("cl,ud->ucdl", lat[:, :, 1], v2))


@dataclasses.dataclass
class Level:
    """One split depth's system: A_lin (the operator on homogeneous
    Dirichlet data), c (what the Dirichlet data add to A x), M (the mass
    matrix), s (the nodal source), in degree-of-freedom order."""
    n: int
    U: int
    C: int
    A: sp.csr_matrix
    c: np.ndarray
    M: sp.csr_matrix
    s: np.ndarray
    coords: np.ndarray          # (U, C, 2, 3)


def _node_ids(P: np.ndarray) -> np.ndarray:
    """(E, 3) ids of coincident child nodes, from coordinates quantised to
    1e-9 of the domain's extent."""
    pts = P.transpose(0, 2, 1).reshape(-1, 2)
    lo = pts.min(axis=0)
    span = max(float(np.ptp(pts, axis=0).max()), 1e-300)
    q = np.round((pts - lo) / (span * 1e-9)).astype(np.int64)
    _, ids = np.unique(q, axis=0, return_inverse=True)
    return ids.reshape(-1, 3)


def _geometry(P: np.ndarray):
    """Areas (E,) and P1 basis gradients (E, 3, 2) of triangles P (E, 2,
    3)."""
    x, y = P[:, 0], P[:, 1]
    det = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (
        x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    grad = np.empty((len(P), 3, 2))
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        grad[:, i, 0] = (y[:, j] - y[:, k]) / det
        grad[:, i, 1] = (x[:, k] - x[:, j]) / det
    return 0.5 * np.abs(det), grad


def _faces(P: np.ndarray, ids: np.ndarray):
    """Every (element, edge) half-face: its neighbour element (-1 on the
    domain boundary), the neighbour's local node at each of my two edge
    nodes, the edge length and my outward unit normal."""
    E = len(P)
    a, b = EDGES[:, 0], EDGES[:, 1]
    ga, gb = ids[:, a], ids[:, b]                         # (E, 3)
    key = np.stack([np.minimum(ga, gb), np.maximum(ga, gb)], -1).reshape(
        -1, 2)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    if counts.max() > 2:
        raise ValueError("reference mesh: an edge with more than two "
                         "elements")
    order = np.argsort(inv, kind="stable")
    inv_sorted = inv[order]
    nbr_half = np.full(3 * E, -1)
    pair = inv_sorted[1:] == inv_sorted[:-1]
    h1, h2 = order[:-1][pair], order[1:][pair]
    nbr_half[h1], nbr_half[h2] = h2, h1
    nbr = np.where(nbr_half >= 0, nbr_half // 3, -1).reshape(E, 3)
    # the neighbour's local node at my edge node a / b
    safe = np.maximum(nbr, 0)
    nbr_ids = ids[safe]                                   # (E, 3f, 3)
    at_a = np.argmax(nbr_ids == ga[..., None], axis=-1)
    at_b = np.argmax(nbr_ids == gb[..., None], axis=-1)
    pa = P[:, :, a].transpose(0, 2, 1)                    # (E, 3f, 2)
    pb = P[:, :, b].transpose(0, 2, 1)
    t = pb - pa
    length = np.linalg.norm(t, axis=-1)
    normal = np.stack([t[..., 1], -t[..., 0]], -1) / length[..., None]
    opposite = P.transpose(0, 2, 1)[:, [2, 0, 1]]         # node off edge f
    flip = np.sum(normal * (opposite - pa), axis=-1) > 0
    normal[flip] *= -1.0
    return nbr, at_a, at_b, length, normal


def assemble(X: np.ndarray, n: int, level: int, dt: float, theta: float,
             k: float = 1.0, penalty: float = 3.0) -> Level:
    """The level of split depth n (``level`` = 0 for the finest, i for
    the depth i below it) on macros X: A_lin = M / dt + theta L and the
    Dirichlet term c, so that a step solves A_lin x = b - theta c."""
    coords = child_coords(X, n)
    U, C = coords.shape[:2]
    P = coords.reshape(U * C, 2, 3)
    E = len(P)
    area, grad = _geometry(P)
    ids = _node_ids(P)
    nbr, at_a, at_b, length, normal = _faces(P, ids)
    dof = 3 * np.arange(E)[:, None] + np.arange(3)        # (E, 3)

    rows, cols, vals = [], [], []

    def add(r, c_, v):
        rows.append(r.ravel())
        cols.append(c_.ravel())
        vals.append(v.ravel())

    mass = area[:, None, None] / 12.0 * (np.ones((3, 3)) + np.eye(3))
    stiff = k * area[:, None, None] * np.einsum("eid,ejd->eij", grad, grad)
    R = np.broadcast_to(dof[:, :, None], (E, 3, 3))
    Cc = np.broadcast_to(dof[:, None, :], (E, 3, 3))
    add(R, Cc, stiff)

    c_vec = np.zeros(3 * E)
    g_nodes = np.sin(P[:, 0] + P[:, 1])                   # (E, 3)
    for f in range(3):
        a, b = EDGES[f]
        ell = length[:, f]
        nrm = normal[:, f]                                # (E, 2)
        nb = nbr[:, f]
        inner = nb >= 0
        dn = np.einsum("eid,ed->ei", grad, nrm)           # grad phi_i . n
        # face integrals of my basis: int phi_i phi_j, int phi_i
        Mf = np.zeros((E, 3, 3))
        Mf[:, a, a] = Mf[:, b, b] = ell / 3.0
        Mf[:, a, b] = Mf[:, b, a] = ell / 6.0
        If = np.zeros((E, 3))
        If[:, a] = If[:, b] = ell / 2.0
        nb_area = np.where(inner, area[np.maximum(nb, 0)], area)
        sigma = penalty * k * ell / np.minimum(area, nb_area) * 2.0 ** level
        w = np.where(inner, 0.5, 1.0)
        # my own values: penalty, consistency ({grad T . n}: half of mine
        # inside, all of it on the boundary), symmetry
        own = (sigma[:, None, None] * Mf
               - k * w[:, None, None] * If[:, :, None] * dn[:, None, :]
               - k * w[:, None, None] * dn[:, :, None] * If[:, None, :])
        add(R, Cc, own)
        # the neighbour's values, at its nodes that sit on my edge nodes
        e_in = np.nonzero(inner)[0]
        m = nb[e_in]
        na, nbn = at_a[e_in, f], at_b[e_in, f]
        dn_nb = np.einsum("eid,ed->ei", grad[m], nrm[e_in])
        cross = np.zeros((len(e_in), 3, 3))
        r_ = np.arange(len(e_in))
        for i in range(3):
            cross[r_, i, na] -= sigma[e_in] * Mf[e_in, i, a]
            cross[r_, i, nbn] -= sigma[e_in] * Mf[e_in, i, b]
            # symmetry: + 1/2 k (grad phi_i . n) int T_nb
            cross[r_, i, na] += 0.5 * k * dn[e_in, i] * If[e_in, a]
            cross[r_, i, nbn] += 0.5 * k * dn[e_in, i] * If[e_in, b]
        # consistency: - 1/2 k int phi_i (grad T_nb . n)
        cross -= 0.5 * k * If[e_in][:, :, None] * dn_nb[:, None, :]
        add(np.broadcast_to(dof[e_in][:, :, None], cross.shape),
            np.broadcast_to(dof[m][:, None, :], cross.shape), cross)
        # Dirichlet data g on boundary edges (linear between its values at
        # my two edge nodes): - sigma int phi_i g + k (grad phi_i . n)
        # int g
        e_bd = np.nonzero(~inner)[0]
        gab = g_nodes[e_bd][:, [a, b]]                    # (nb, 2)
        int_phi_g = (Mf[e_bd][:, :, [a, b]] * gab[:, None, :]).sum(-1)
        int_g = 0.5 * ell[e_bd] * gab.sum(-1)
        cb = (-sigma[e_bd, None] * int_phi_g
              + k * dn[e_bd] * int_g[:, None])
        np.add.at(c_vec, dof[e_bd], cb)
    if level > 0:
        # coarse levels solve correction equations: homogeneous data
        c_vec[:] = 0.0

    N = 3 * E
    L = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(N, N))
    M = sp.csr_matrix((mass.ravel(), (R.ravel(), Cc.ravel())), shape=(N, N))
    s = (2.0 * k * g_nodes).reshape(-1)
    A = (M / dt + theta * L).tocsr()
    A.sum_duplicates()
    return Level(n=n, U=U, C=C, A=A, c=c_vec, M=M, s=s, coords=coords)


def rhs(lvl: Level, T_prev: np.ndarray, dt: float) -> np.ndarray:
    """b_lin = M T_prev / dt + M s - c, the right-hand side of the implicit
    (theta = 1) step A_lin x = b_lin."""
    return lvl.M @ T_prev / dt + lvl.M @ lvl.s - lvl.c


def diag_block_inverse(A: sp.csr_matrix) -> sp.csr_matrix:
    """The inverses of A's 3x3 diagonal blocks, as a block-diagonal
    matrix."""
    N = A.shape[0]
    E = N // 3
    idx = 3 * np.arange(E)[:, None] + np.arange(3)
    blocks = np.zeros((E, 3, 3))
    Acoo = A.tocoo()
    same = Acoo.row // 3 == Acoo.col // 3
    np.add.at(blocks, (Acoo.row[same] // 3, Acoo.row[same] % 3,
                       Acoo.col[same] % 3), Acoo.data[same])
    inv = np.linalg.inv(blocks)
    R = np.broadcast_to(idx[:, :, None], (E, 3, 3))
    Cc = np.broadcast_to(idx[:, None, :], (E, 3, 3))
    return sp.csr_matrix((inv.ravel(), (R.ravel(), Cc.ravel())),
                         shape=(N, N))


def prolongation(fine: Level, coarse: Level) -> sp.csr_matrix:
    """Linear interpolation of a coarse P1 function onto the fine
    children: entry ((e_f, l), (e_c, k)) is the k-th barycentric coordinate
    of fine node l of e_f in the coarse child e_c that holds it (the
    coarse child of the same macro that holds e_f's centroid)."""
    U, Cf, Cc = fine.U, fine.C, coarse.C
    Pf = fine.coords                                      # (U, Cf, 2, 3)
    Pc = coarse.coords                                    # (U, Cc, 2, 3)
    # barycentric coordinates of each fine node in each coarse child of
    # its macro: (U, Cf, Cc, 3 nodes, 3 coords)
    V2 = Pc[:, :, :, 2]                                   # (U, Cc, 2)
    Tm = np.stack([Pc[:, :, :, 0] - V2, Pc[:, :, :, 1] - V2], -1)
    Tinv = np.linalg.inv(Tm)                              # (U, Cc, 2, 2)
    d = Pf[:, :, None, :, :] - V2[:, None, :, :, None]   # (U, Cf, Cc, 2, 3)
    lam01 = np.einsum("ucab,ufcbl->ufcla", Tinv, d)       # (U,Cf,Cc,3,2)
    lam = np.concatenate([lam01, 1.0 - lam01.sum(-1, keepdims=True)], -1)
    cent = lam.mean(axis=3)                               # (U, Cf, Cc, 3)
    parent = np.argmax(cent.min(axis=-1), axis=-1)        # (U, Cf)
    if (np.take_along_axis(cent.min(-1), parent[..., None], -1)
            < -1e-9).any():
        raise ValueError("prolongation: a fine child outside its macro's "
                         "coarse children")
    w = np.take_along_axis(
        lam, parent[:, :, None, None, None], axis=2)[:, :, 0]  # (U,Cf,3,3)
    u = np.arange(U)[:, None]
    ef = u * Cf + np.arange(Cf)                           # (U, Cf)
    ec = u * Cc + parent
    r = 3 * ef[:, :, None, None] + np.arange(3)[:, None]  # fine node l
    c_ = 3 * ec[:, :, None, None] + np.arange(3)[None, :]  # coarse node k
    r, c_ = np.broadcast_arrays(r, c_)
    return sp.csr_matrix((w.ravel(), (r.ravel(), c_.ravel())),
                         shape=(3 * U * Cf, 3 * U * Cc))

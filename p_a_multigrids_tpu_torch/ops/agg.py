"""Smoothed-aggregation (SA) levels below, or in place of, the geometric
hierarchy.

Elements are aggregated in groups of ~4 on the (strength-filtered) element
graph; each aggregate keeps 3 coarse DOFs spanning the locally linear
near-nullspace [1, x, y]; the tentative prolongation is Jacobi-smoothed and
the coarse operator is the Galerkin product P^T A P.  Levels repeat until
the system is small enough for a dense inverse.

The host half (``build_hierarchy`` and its helpers) is numpy and scipy
copied from the JAX package's ``ops/agg.py`` and yields the same tables bit
for bit, without the TPU kernel's banded embedding, row padding and slot
chunking.  The device half (``AggHierarchy`` and the cycle functions) holds
every level operator and transfer as a ``spmv.RowOp``, so each of their
applications is one launch of kernel K2 on the GPU; there the V-cycles
below the corrected level (``vcycle_iter``) replay as one CUDA graph
(``ops/cuda_graph``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch import nn

from ..mesh import splitting
from ..utils import tracing
from . import cuda_graph, spmv
from .spmv import RowOp
from .stencil import StencilData, inv3x3


@dataclasses.dataclass
class HostLevel:
    """One SA level's host tables.

    The operator and both transfers are padded fixed-degree block-row
    tables: row e couples to block columns ``*_cols[e, :]`` through dense
    3x3 ``*_vals`` blocks (zero blocks pad short rows).
    """
    cols: np.ndarray       # (N, D) int32 operator columns
    vals: np.ndarray       # (N, D, 3, 3)
    dinv: np.ndarray       # (N, 3, 3) inverse diagonal blocks
    agg: np.ndarray        # (Ne_fine,) int32 aggregate of each fine element
    Pb: np.ndarray         # (Ne_fine, 3, 3) tentative prolongation blocks
    p_cols: np.ndarray     # (Ne_fine, Dp) prolongation: fine <- coarse
    p_vals: np.ndarray     # (Ne_fine, Dp, 3, 3)
    r_cols: np.ndarray     # (N, Dr) restriction: coarse <- fine
    r_vals: np.ndarray     # (N, Dr, 3, 3)
    n: int                 # number of aggregates at this level
    # spectrally safe Jacobi weight 4/(3 lam_max(D^-1 A)), at most omega
    omega: float = 0.8


@dataclasses.dataclass
class HostHierarchy:
    levels: list[HostLevel]
    coarse_inv: np.ndarray | None    # scaled dense inverse at the bottom
    coarse_scale: np.ndarray | None  # D^-1/2 Jacobi scaling of that inverse
    omega: float
    sweeps: int
    # factored fine transfers P = (I - w D^-1 A) P_tent: dict(w, dinv_t
    # (3, E) scalar inverse diagonal, r_cols/r_vals (na, m) tentative
    # member-sum restriction, p_cols/p_vals (E, 1) tentative prolongation)
    fine: dict | None = None


# -- host-side construction (numpy, bit-identical to the JAX package) ---------

MAX_LEVELS = 12          # SA levels below the corrected one, at most
# the span of each level's V-cycle (``vcycle``), named once
LEVEL_SPANS = tuple(f"pamg.sa.l{k}" for k in range(MAX_LEVELS))
# the span of a replay of the SA cycle's graph: the input copy and the
# graph launch
GRAPH_SPAN = "pamg.sa.graph"


def _csr_from_stencil(data: StencilData):
    """Block matrix + element count of a stencil level (scipy CSR).

    Reads the intra-macro couplings through the splitting lattice, so a
    macro-packed level (``slot_mf`` set) would give a wrong matrix: it
    raises instead."""
    from scipy import sparse

    if getattr(data, "slot_mf", None) is not None:
        raise ValueError("_csr_from_stencil: macro-packed stencil data "
                         "(slot_mf set) does not follow the splitting "
                         "lattice; build the SA hierarchy from the unpacked "
                         "level")
    U, C = data.self_blocks.shape[:2]
    E = U * C
    s = int(round(np.log(C) / np.log(4))) if C > 1 else 0
    cn = splitting.child_neighbors(s)

    rows, cols, vals = [], [], []
    e_all = np.arange(E)
    rows.append(e_all)
    cols.append(e_all)
    vals.append(data.self_blocks.reshape(E, 3, 3))
    eids = e_all.reshape(U, C)
    for c in range(C):
        for f in range(3):
            if cn[c, f] >= 0:
                rows.append(eids[:, c])
                cols.append(eids[:, cn[c, f]])
                vals.append(data.face_blocks[:, c, f])
    for slot in range(len(data.bnd_c)):
        blk = data.cross_blocks[:, slot]
        keep = np.abs(blk).max(axis=(1, 2)) > 0
        rows.append(eids[keep, data.bnd_c[slot]])
        cols.append(np.asarray(data.halo_src)[keep, slot])
        vals.append(blk[keep])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals, axis=0)                 # (nblk, 3, 3)
    i_, j_ = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    rs = (3 * r[:, None, None] + i_[None]).ravel()
    cs = (3 * c[:, None, None] + j_[None]).ravel()
    A = sparse.coo_matrix((v.ravel(), (rs, cs)),
                          shape=(3 * E, 3 * E)).tocsr()
    A.sum_duplicates()
    return A, E


def _element_graph(A, E: int, strength: float = 0.0):
    """Element adjacency (lists) from the 3x3-blocked CSR pattern.

    With ``strength`` > 0 only strong connections survive: the block
    coupling norm must reach ``strength`` times the row's strongest
    off-diagonal coupling, so aggregates line up with the anisotropy.
    """
    Ab = A.tobsr(blocksize=(3, 3))
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    norms = np.abs(data).max(axis=(1, 2))
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(E), deg)
    off = indices != rows
    masked = np.where(off, norms, 0.0)
    row_max = np.zeros(E)
    nz_rows = deg > 0
    if nz_rows.any():
        red = np.maximum.reduceat(masked, indptr[:-1][nz_rows])
        row_max[nz_rows] = red
    keep = off & (norms >= strength * row_max[rows])
    adj_rows = rows[keep]
    adj_cols = indices[keep]
    counts = np.bincount(adj_rows, minlength=E)
    splits = np.cumsum(counts)[:-1]
    chunks = np.split(adj_cols, splits)
    return [c.tolist() for c in chunks]


def _aggregate(adj, E: int, target: int = 4) -> np.ndarray:
    """Greedy BFS aggregation into groups of ~``target`` elements."""
    agg = -np.ones(E, np.int64)
    na = 0
    for seed in range(E):
        if agg[seed] >= 0:
            continue
        members = [seed]
        agg[seed] = na
        frontier = [seed]
        while frontier and len(members) < target:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if agg[v] < 0 and len(members) < target:
                        agg[v] = na
                        members.append(v)
                        nxt.append(v)
            frontier = nxt
        na += 1
    # attach surviving singletons to a neighboring aggregate (keeps the
    # coarse blocks well-conditioned)
    sizes = np.bincount(agg, minlength=na)
    for e in range(E):
        if sizes[agg[e]] == 1:
            for v in adj[e]:
                if sizes[agg[v]] > 1:
                    sizes[agg[e]] -= 1
                    agg[e] = agg[v]
                    sizes[agg[e]] += 1
                    break
    uniq, agg = np.unique(agg, return_inverse=True)
    return agg


def _tentative_P(agg: np.ndarray, B: np.ndarray):
    """Per-aggregate QR of the near-nullspace -> (Pb, B_coarse).

    B (E, 3, 3): near-nullspace values at each element's 3 dofs (last axis
    = the 3 nullspace vectors).  Returns Pb (E, 3, 3) orthonormal blocks
    and the coarse-level nullspace B_c (Na, 3, 3); aggregates are grouped
    by size and each size class runs one batched QR.
    """
    E = B.shape[0]
    na = int(agg.max()) + 1
    Pb = np.zeros((E, 3, 3))
    Bc = np.zeros((na, 3, 3))
    order = np.argsort(agg, kind="stable")
    sizes = np.bincount(agg, minlength=na)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    for sz in np.unique(sizes):
        aggs = np.nonzero(sizes == sz)[0]
        rows = order[bounds[aggs][:, None] + np.arange(sz)[None, :]]
        Ba = B[rows].reshape(len(aggs), sz * 3, 3)
        Q, R = np.linalg.qr(Ba)
        diag = np.abs(np.diagonal(R, axis1=-2, axis2=-1))
        bad = diag < 1e-12 * np.maximum(diag.max(axis=-1, keepdims=True),
                                        1e-30)
        if bad.any():
            Q = np.where(bad[:, None, :], 0.0, Q)
            fix = bad[:, :, None] | bad[:, None, :]
            R = np.where(fix, np.eye(3)[None], R)
        Pb[rows.reshape(-1)] = Q.reshape(len(aggs), sz, 3, 3).reshape(
            -1, 3, 3)
        Bc[aggs] = R
    return Pb, Bc


def _padded_operator(A, E: int, max_deg: int = 18, drop_tol: float = 1e-4):
    """CSR block matrix -> padded fixed-degree (cols, vals, diag) tables.

    Standard SA filtering: blocks with norm below ``drop_tol *
    sqrt(|diag_i| |diag_j|)`` are dropped and each row keeps at most
    ``max_deg`` strongest couplings (the diagonal always survives).
    """
    Ab = A.tobsr(blocksize=(3, 3))
    indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(E), deg)
    norms = np.abs(data).max(axis=(1, 2))
    is_diag = indices == rows
    dnorm = np.full(E, 1e-300)
    dnorm[rows[is_diag]] = np.maximum(norms[is_diag], 1e-300)
    diag = np.zeros((E, 3, 3))
    diag[rows[is_diag]] = data[is_diag]

    strong = (norms >= drop_tol * np.sqrt(dnorm[rows] * dnorm[indices])
              ) | is_diag
    kdeg = np.zeros(E, np.int64)
    np.add.at(kdeg, rows[strong], 1)
    for e in np.nonzero(kdeg > max_deg)[0]:
        sl = slice(indptr[e], indptr[e + 1])
        idx = np.arange(sl.start, sl.stop)[strong[sl]]
        order = idx[np.argsort(-(norms[idx] + 1e30 * is_diag[idx]))]
        strong[order[max_deg:]] = False
    keep = np.nonzero(strong)[0]
    new_deg = np.zeros(E, np.int64)
    np.add.at(new_deg, rows[keep], 1)
    new_indptr = np.concatenate([[0], np.cumsum(new_deg)])
    cols, vals = _ragged_to_padded(new_indptr, indices[keep], data[keep], E)
    # zero slots (padding) become harmless self references
    pad = np.abs(vals).max(axis=(2, 3)) == 0
    cols = np.where(pad, np.arange(E)[:, None], cols)
    return cols, vals, diag


def build_hierarchy(data: StencilData, dof_coords: np.ndarray,
                    max_dense_dof: int = 4096, omega: float = 0.8,
                    sweeps: int = 2, dtype=np.float32,
                    strength: float = 0.0,
                    always: bool = False,
                    drop_tol: float = 1e-4,
                    target: int = 4) -> HostHierarchy:
    """SA hierarchy under one stencil level (host numpy).

    Args:
      data: the stencil blocks of the level the hierarchy corrects
      dof_coords: (U, C, 2, 3) node coordinates of that level's children
      max_dense_dof: stop and invert densely at/below this many DOF
      strength: strength-of-connection threshold of the aggregation graph
      always: coarsen at least once even when the system is already small
        (amg mode wants a correction)
    The tentative prolongation is Jacobi-smoothed (classical SA:
    P = (I - 4/(3 lam_max) D^-1 A) P_tent), at most ``MAX_LEVELS`` levels.
    Tables are cast to ``dtype`` (indices to int32) as the JAX package's
    device tables are.
    """
    from scipy import sparse

    A, E = _csr_from_stencil(data)
    xy = dof_coords.transpose(0, 1, 3, 2).reshape(E, 3, 2)
    B = np.concatenate([np.ones((E, 3, 1)), xy], axis=2)   # (E, 3dof, 3ns)

    levels: list[HostLevel] = []
    fine: dict | None = None
    for _ in range(MAX_LEVELS):
        if A.shape[0] <= max_dense_dof and (levels or not always):
            break
        adj = _element_graph(A, E, strength=strength)
        agg = _aggregate(adj, E, target=target)
        na = int(agg.max()) + 1
        if na >= E:              # no coarsening possible
            break
        Pb, Bc = _tentative_P(agg, B)
        rows = np.repeat(np.arange(E) * 3, 9) + np.tile(
            np.repeat(np.arange(3), 3), E)
        cols_p = np.repeat(agg * 3, 9) + np.tile(np.arange(3), 3 * E)
        P = sparse.csr_matrix((Pb.reshape(-1), (rows, cols_p)),
                              shape=(3 * E, 3 * na))
        dinv_s = 1.0 / np.maximum(np.abs(A.diagonal()), 1e-300)
        DA = sparse.diags(dinv_s) @ A
        w_smooth = 4.0 / (3.0 * _power_lam(DA))
        P = (P - w_smooth * (DA @ P)).tocsr()
        Ac = (P.T @ A @ P).tocsr()
        Ac.sum_duplicates()
        # relabel aggregates by their first member: the coarse order stays
        # aligned with the fine (RCM) order, so the gathers of the level
        # operator and of both transfers stay local
        first = np.full(na, E, np.int64)
        np.minimum.at(first, agg, np.arange(E))
        perm = np.argsort(first, kind="stable")          # new k = old perm[k]
        inv_p = np.argsort(perm)
        perm3 = (3 * perm[:, None] + np.arange(3)).ravel()
        Ac = Ac[perm3][:, perm3].tocsr()
        P = P[:, perm3].tocsr()
        Bc = Bc[perm]
        agg = inv_p[agg]
        if not levels:
            # factored fine transfers: member-sum tentative tables (pad
            # slots repeat the first member with zero blocks) + the Jacobi
            # smoothing weight and diagonal
            sizes = np.bincount(agg, minlength=na)
            order = np.argsort(agg, kind="stable")
            bounds = np.concatenate([[0], np.cumsum(sizes)])
            a_of = agg[order]
            pos = np.arange(E) - bounds[a_of]
            m_max = int(sizes.max())
            tr_cols = np.zeros((na, m_max), np.int64)
            tr_vals = np.zeros((na, m_max, 3, 3))
            tr_cols[a_of, pos] = order
            tr_vals[a_of, pos] = Pb[order].swapaxes(-1, -2)
            fine = dict(w=w_smooth,
                        dinv_t=dinv_s.reshape(E, 3).T.astype(dtype),
                        r_cols=tr_cols.astype(np.int32),
                        r_vals=tr_vals.astype(dtype),
                        p_cols=agg[:, None].astype(np.int32),
                        p_vals=Pb[:, None].astype(dtype))
        cols, vals, diag = _padded_operator(Ac, na, drop_tol=drop_tol)
        p_cols, p_vals = _padded_transfer(P, E, na)
        r_cols, r_vals = _padded_transfer(P.T.tocsr(), na, E)
        lam_c = _power_lam_blocks(cols, vals, inv3x3(diag))
        levels.append(HostLevel(
            cols=cols.astype(np.int32), vals=vals.astype(dtype),
            dinv=inv3x3(diag).astype(dtype), agg=agg.astype(np.int32),
            Pb=Pb.astype(dtype),
            p_cols=p_cols.astype(np.int32), p_vals=p_vals.astype(dtype),
            r_cols=r_cols.astype(np.int32), r_vals=r_vals.astype(dtype),
            n=na, omega=min(float(4.0 / (3.0 * lam_c)), omega)))
        A, E, B = Ac, na, Bc

    coarse_inv = None
    coarse_scale = None
    if levels and A.shape[0] <= max_dense_dof:
        # invert the symmetrically Jacobi-scaled matrix (f64 on the host):
        # D^-1/2 A D^-1/2 sheds the scaling's conditioning, so the f32
        # matmul of the cycle stays accurate; vcycle applies S As^-1 S
        s_vec = 1.0 / np.sqrt(np.maximum(np.abs(A.diagonal()), 1e-300))
        As = (A.toarray() * s_vec[None, :]) * s_vec[:, None]
        coarse_inv = np.linalg.inv(As).astype(dtype)
        coarse_scale = s_vec.astype(dtype)
    return HostHierarchy(levels=levels, coarse_inv=coarse_inv,
                         coarse_scale=coarse_scale, omega=omega,
                         sweeps=sweeps, fine=fine)


def _power_lam_blocks(cols, vals, dinv, iters: int = 15,
                      seed: int = 0) -> float:
    """lam_max(Dblock^-1 A) for the padded block operator (numpy)."""
    N = cols.shape[0]
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N, 3))

    def apply_(x):
        y = np.einsum("ndij,ndj->ni", vals, x[cols], optimize=True)
        return np.einsum("nij,nj->ni", dinv, y, optimize=True)

    for _ in range(iters):
        w = apply_(v)
        nw = np.linalg.norm(w)
        if nw == 0:
            return 1.0
        v = w / nw
    return max(float(np.linalg.norm(apply_(v))) * 1.1, 1e-12)


def _power_lam(DA, iters: int = 15, seed: int = 0) -> float:
    """lam_max(D^-1 A) by power iteration (scipy matvecs)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=DA.shape[0])
    for _ in range(iters):
        w = DA @ v
        nw = np.linalg.norm(w)
        if nw == 0:
            return 1.0
        v = w / nw
    return max(float(np.linalg.norm(DA @ v)), 1e-12)


def _ragged_to_padded(indptr, indices, data, n_rows: int):
    """Vectorized CSR blocks -> zero-padded (cols (N, D), vals (N, D, b, b))."""
    deg = np.diff(indptr)
    D = int(deg.max()) if len(deg) and deg.max() > 0 else 1
    b = data.shape[-1] if data.ndim == 3 else 1
    cols = np.zeros((n_rows, D), np.int64)
    vals = np.zeros((n_rows, D, b, b))
    if len(indices):
        rows = np.repeat(np.arange(n_rows), deg)
        pos = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
        cols[rows, pos] = indices
        vals[rows, pos] = data
    return cols, vals


def _padded_transfer(P, n_rows_blk: int, n_cols_blk: int):
    """Scalar CSR transfer -> padded block-row tables (cols (N, D) block
    column ids, vals (N, D, 3, 3)) with y[e] = sum_d vals[e, d] @
    x[cols[e, d]] reproducing P (or P^T)."""
    Pb = P.tobsr(blocksize=(3, 3))
    return _ragged_to_padded(Pb.indptr, Pb.indices, Pb.data, n_rows_blk)


# -- device-side cycle ----------------------------------------------------------


class AggLevel(nn.Module):
    """One SA level on a device: its operator, restriction (from the level
    above) and prolongation (to the level above) as ``RowOp``s, and its
    inverse diagonal blocks ``dinv_t`` (3i, 3j, N)."""

    def __init__(self, lvl: HostLevel, dtype: torch.dtype, device):
        super().__init__()
        n_fine = lvl.p_cols.shape[0]
        self.n = int(lvl.n)
        self.omega = float(lvl.omega)
        self.op = RowOp(lvl.cols, lvl.vals, self.n, dtype, device)
        self.rstr = RowOp(lvl.r_cols, lvl.r_vals, n_fine, dtype, device)
        self.prol = RowOp(lvl.p_cols, lvl.p_vals, self.n, dtype, device)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.register_buffer("dinv_t", torch.tensor(np.ascontiguousarray(
            np.asarray(lvl.dinv, np_dtype).transpose(1, 2, 0)),
            device=device))


class AggHierarchy(nn.Module):
    """The SA hierarchy on a device (``HostHierarchy`` moved over).

    ``levels`` are ``AggLevel``s; ``tent_r``/``tent_p`` are the factored
    fine transfers' tentative restriction (na, m) and prolongation (E, 1)
    (None without them); ``fine_dinv_t`` (3, E) their scalar inverse
    diagonal and ``w`` their smoothing weight; ``coarse_inv``,
    ``coarse_scale`` the scaled dense bottom (None when the hierarchy ends
    without one); ``graphs`` the ``cuda_graph.Graph``s of ``vcycle_iter`` on
    the card, one by (dtype, device, shape, ncycles)."""

    def __init__(self, host: HostHierarchy, dtype: torch.dtype, device):
        super().__init__()
        if not host.levels:
            raise ValueError("AggHierarchy: the host hierarchy has no level")
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.levels = nn.ModuleList(AggLevel(lv, dtype, device)
                                    for lv in host.levels)
        self.omega = float(host.omega)
        self.sweeps = int(host.sweeps)

        def buf(name, a):
            self.register_buffer(name, None if a is None else torch.tensor(
                np.ascontiguousarray(np.asarray(a, np_dtype)), device=device))

        buf("coarse_inv", host.coarse_inv)
        buf("coarse_scale", host.coarse_scale)
        f = host.fine
        self.w = None if f is None else float(f["w"])
        buf("fine_dinv_t", None if f is None else f["dinv_t"])
        n0, e0 = self.levels[0].n, host.levels[0].p_cols.shape[0]
        self.tent_r = (None if f is None else
                       RowOp(f["r_cols"], f["r_vals"], e0, dtype, device))
        self.tent_p = (None if f is None else
                       RowOp(f["p_cols"], f["p_vals"], n0, dtype, device))
        self.graphs: dict = {}
        # the operators vcycle applies: level 0's, and each lower level's
        # with the transfers between it and the level above
        self._cycle_ops = [self.levels[0].op] + [
            op for lv in self.levels[1:] for op in (lv.op, lv.rstr, lv.prol)]

    def rowops(self) -> dict:
        """Every block-row operator of the hierarchy by name."""
        out = {}
        for k, lv in enumerate(self.levels):
            out.update({f"l{k}_op": lv.op, f"l{k}_r": lv.rstr,
                        f"l{k}_p": lv.prol})
        if self.tent_r is not None:
            out.update(fine_tent_r=self.tent_r, fine_tent_p=self.tent_p)
        return out


def _dinv_mul(lvl: AggLevel, r_t):
    """Block-diagonal D^-1 r in transposed layout."""
    return (lvl.dinv_t * r_t[None]).sum(dim=1)


def _smooth(lvl: AggLevel, x_t, b_t, omega, sweeps):
    # the level's spectral weight, never above the configured omega
    w = min(lvl.omega, omega)
    for _ in range(sweeps):
        r_t = b_t - lvl.op(x_t)
        x_t = x_t + w * _dinv_mul(lvl, r_t)
    return x_t


def _smooth_from_zero(lvl: AggLevel, b_t, omega, sweeps):
    """_smooth with x0 = 0: the first sweep's residual is b, so its
    operator apply is skipped (the same arithmetic)."""
    w = min(lvl.omega, omega)
    x_t = w * _dinv_mul(lvl, b_t)
    return _smooth(lvl, x_t, b_t, omega, sweeps - 1) if sweeps > 1 else x_t


def vcycle(h: AggHierarchy, k: int, b_t):
    """Homogeneous-start V-cycle over the SA levels from level k, the span
    ``pamg.sa.l<k>`` (on the card only inside ``_capture``).

    ``b_t`` is the residual restricted into level k, transposed (3, N_k);
    returns the correction in the same layout.
    """
    lvl = h.levels[k]
    with tracing.span(LEVEL_SPANS[k]):
        x_t = _smooth_from_zero(lvl, b_t, h.omega, h.sweeps)
        r_t = b_t - lvl.op(x_t)
        if k + 1 < len(h.levels):
            nxt = h.levels[k + 1]
            ec = vcycle(h, k + 1, nxt.rstr(r_t))
            x_t = x_t + nxt.prol(ec)
        elif h.coarse_inv is not None:
            rs = h.coarse_scale * r_t.T.reshape(-1)
            ec = h.coarse_scale * (h.coarse_inv @ rs)
            x_t = x_t + ec.reshape(r_t.shape[1], 3).T
        return _smooth(lvl, x_t, b_t, h.omega, h.sweeps)


def _vcycle_iter(h: AggHierarchy, rc, ncycles: int):
    e = vcycle(h, 0, rc)
    for _ in range(ncycles - 1):
        e = e + vcycle(h, 0, rc - h.levels[0].op(e))
    return e


# the SA cycle's graph: K2's launches, a replay's result the static output
SA_GRAPH = cuda_graph.Kind(GRAPH_SPAN, "sa_graph",
                           (("k2", (spmv.KERNEL, spmv.CHECKED)),),
                           copy_out=False)


def _sites(h: AggHierarchy) -> tuple:
    return tuple(op.sanitizer for op in h._cycle_ops)


@contextlib.contextmanager
def _k2_least_bytes(ops):
    """The watch of a capture: yields a list that holds, once the block
    has run, the least bytes of each of its calls of ``ops``
    (``utils.profiling.rowop_least_bytes``, read after the block, since
    reading them syncs with the card); forward pre-hooks record the
    calls."""
    from ..utils.profiling import rowop_least_bytes

    applied, out = [], []
    hooks = [op.register_forward_pre_hook(lambda m, _: applied.append(m))
             for op in ops]
    try:
        yield out
    finally:
        for hook in hooks:
            hook.remove()
    least = {id(op): rowop_least_bytes(op, op.vals_t.element_size())
             for op in ops}
    out.extend(least[id(op)] for op in applied)


def _capture(h: AggHierarchy, rc, ncycles: int):
    """The first call on the card for rc's dtype, device and shape, or
    the first after the operators' sanitizer sites changed: returns (the
    ``cuda_graph.Graph`` of the cycles, their result on rc), as
    ``cuda_graph.capture`` makes them, with the least bytes of the K2
    calls the capture recorded."""
    return cuda_graph.capture(SA_GRAPH, lambda x: _vcycle_iter(h, x, ncycles),
                              (rc,), _sites(h), _k2_least_bytes(h._cycle_ops))


def vcycle_iter(h: AggHierarchy, rc, ncycles: int = 1):
    """ncycles V-cycles on the level-0 SA system (transposed).

    On a CPU tensor the cycles run eagerly.  On a CUDA tensor they are one
    replay of the hierarchy's graph for rc's dtype, device, shape and
    ``ncycles`` (``cuda_graph.cached``, in ``h.graphs``), captured at the
    first such call and captured again, in its place, when the operators'
    sanitizer sites have changed since: the result is then the graph's
    static output, which the next replay overwrites, so use it before
    calling again (both callers feed it at once to a transfer on the same
    stream).
    """
    if rc.device.type != "cuda":
        return _vcycle_iter(h, rc, ncycles)
    return cuda_graph.cached(
        h.graphs, (rc.dtype, rc.device, tuple(rc.shape), ncycles), _sites(h),
        lambda: _capture(h, rc, ncycles), (rc,))


def correct_t(h: AggHierarchy, r_fine_t, ncycles: int = 1):
    """SA correction of the corrected level from its residual through the
    stored smoothed transfers: r (3, E) -> correction (3, E).  A fixed
    linear operator, so the enclosing V-cycle stays a valid
    preconditioner."""
    lvl0 = h.levels[0]
    return lvl0.prol(vcycle_iter(h, lvl0.rstr(r_fine_t), ncycles))


def tent_restrict(h: AggHierarchy, y_fine_t):
    """Tentative (member-sum) restriction P_tent^T y of the factored fine
    transfers: (3, E) -> (3, na)."""
    if h.tent_r is None:
        raise ValueError("tent_restrict: the hierarchy has no factored "
                         "fine transfers")
    return h.tent_r(y_fine_t)


def tent_prolong(h: AggHierarchy, e_t):
    """Tentative prolongation P_tent e: (3, na) -> (3, E)."""
    if h.tent_p is None:
        raise ValueError("tent_prolong: the hierarchy has no factored "
                         "fine transfers")
    return h.tent_p(e_t)


def correct(h: AggHierarchy, r_fine, ncycles: int = 1):
    """``correct_t`` in the standard layout: (E, 3) -> (E, 3)."""
    return correct_t(h, r_fine.T.contiguous(), ncycles).T.contiguous()

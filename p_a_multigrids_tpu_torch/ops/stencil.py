"""Exact fixed-degree block stencil of the theta-implicit DG operator.

Every child element couples to itself and to at most 3 face neighbors
through dense 3x3 blocks, so ``A = M/dt + theta*L`` is

    out[u, c] = S[u, c] @ x[u, c] + sum_f F[u, c, f] @ x[neighbor(u, c, f)]
                (+ affine Dirichlet-ghost vector when with_bc)

The host half (``StencilData``, ``build_stencil``, ``to_dense``,
``inv3x3``, ``lam_max_estimate``) is numpy copied from the JAX package's
``ops/stencil.py`` and yields the same arrays bit for bit.
``probe_stencil`` extracts the same blocks numerically instead, by probing
the port's own ``models.semi.apply_A`` (float64, on the CPU) with basis
fields: the self-validating cross-check of the closed form.  The device half
is ``StencilOperator``, an ``nn.Module`` whose coefficient planes and index
tables are registered buffers; its plain PyTorch ``_z`` is one round of the
relaxation phase that kernel K1 (``ops/phase.py``) runs on the GPU.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..mesh import splitting


@dataclasses.dataclass
class StencilData:
    """Block stencil + static index sets for one level (host numpy)."""
    self_blocks: np.ndarray    # (U, C, 3, 3)
    face_blocks: np.ndarray    # (U, C, 3, 3, 3) [f, i, j] j = neighbor dof
    cross_blocks: np.ndarray   # (U, nb, 3, 3) coupling to halo source dofs
    c_aff: np.ndarray          # (U, C, 3) Dirichlet-ghost affine vector
    halo_src: np.ndarray       # (U, nb) flattened (u*C + c) source element
    bnd_c: np.ndarray          # (nb,) strip child of each slot
    bnd_f: np.ndarray          # (nb,) strip face of each slot
    intra_onehot: np.ndarray   # (3, C, C): xg[f] = intra_onehot[f] @ x-plane
    cross_onehot: np.ndarray   # (3, C, nb): + cross_onehot[f] @ strip
    # strip-slot face groups of a macro-packed level (the JAX package's
    # pack_stencil); None on the levels this port builds
    slot_mf: np.ndarray | None = None


def slot_groups(data: StencilData):
    """(mf_of, groups, F): strip slots grouped so that all slots of a group
    source one neighbor macro per row (3 groups, the macro faces, on an
    unpacked level; 3*p on a packed one)."""
    bnd_f = np.asarray(data.bnd_f)
    if getattr(data, "slot_mf", None) is not None:
        mf_of = np.asarray(data.slot_mf)
        F = int(mf_of.max()) + 1 if len(mf_of) else 3
    else:
        mf_of = splitting.CHILD2MACRO_FACE[bnd_f]
        F = 3
    groups = [np.nonzero(mf_of == mf)[0] for mf in range(F)]
    return mf_of, groups, F


def _distance2_coloring(cn: np.ndarray) -> np.ndarray:
    """Greedy distance-2 coloring of the child adjacency graph: children of
    one color are pairwise non-adjacent and share no neighbor, so a probe
    can light a whole color class and every response entry still has one
    source."""
    C = cn.shape[0]
    adj = [set() for _ in range(C)]
    for c in range(C):
        for f in range(3):
            if cn[c, f] >= 0:
                adj[c].add(int(cn[c, f]))
    color = -np.ones(C, np.int64)
    for c in range(C):
        banned = set()
        # distance-1 and distance-2 neighbors
        for n1 in adj[c] | {c}:
            for n2 in adj[n1] | {n1}:
                if color[n2] >= 0:
                    banned.add(int(color[n2]))
        k = 0
        while k in banned:
            k += 1
        color[c] = k
    return color


def probe_stencil(L: dict, phys, dt: float, theta: float) -> StencilData:
    """The exact block stencil of ``models.semi.apply_A`` by basis probing
    in float64 on the CPU: one probe per (color, dof) of a distance-2
    coloring, each applied with the intra-macro couplings only, with none,
    and with the cross-macro couplings of one face at a time."""
    from ..models import semi as msemi

    U = int(L["M"].shape[0])
    C = int(L["updown"].shape[0])
    cn = splitting.child_neighbors(L["s"])                  # (C, 3)
    intra_mask = cn >= 0
    bnd_c, bnd_f = np.nonzero(~intra_mask)
    nb = len(bnd_c)
    neigh = np.asarray(L["neigh_elem"])                     # (U, C, 3)
    cross_mask = torch.as_tensor((~intra_mask)[None] & (neigh >= 0))
    color = _distance2_coloring(cn)
    ncol = int(color.max()) + 1

    # float64 CPU copies of the level tables (probing accuracy)
    Lp = msemi.level_tensors(
        {key: (np.asarray(L[key], np.float64)
               if np.asarray(L[key]).dtype.kind == "f" else L[key])
         for key in msemi.OPERATOR_KEYS + ("s",)}, "cpu")
    zero = torch.zeros((), dtype=torch.float64)

    def keep_only(mask):
        def gather(Ld, X):
            full = msemi.flat_gather(Ld, X)
            m = mask.reshape(mask.shape + (1,) * (full.ndim - 3))
            return torch.where(m, full, zero)
        return gather

    faces = torch.arange(3).reshape(1, 1, 3)
    gathers = [keep_only(~cross_mask), keep_only(torch.zeros_like(
        cross_mask))] + [keep_only(cross_mask & (faces == f))
                         for f in range(3)]

    probes = np.zeros((3 * ncol, U, C, 3))
    for c0 in range(C):
        for j in range(3):
            probes[color[c0] * 3 + j, :, c0, j] = 1.0

    def responses(gather):
        return np.stack([msemi.apply_A(Lp, phys, dt, theta,
                                       torch.as_tensor(p), False,
                                       gather).numpy() for p in probes])

    resp_intra, resp_zero = responses(gathers[0]), responses(gathers[1])
    resp_cross = [responses(g) - resp_zero for g in gathers[2:]]
    c_aff = msemi.apply_A(Lp, phys, dt, theta,
                          torch.zeros((U, C, 3), dtype=torch.float64), True,
                          gathers[0]).numpy()

    # -- extraction ----------------------------------------------------------
    self_blocks = np.zeros((U, C, 3, 3))
    face_blocks = np.zeros((U, C, 3, 3, 3))
    for c0 in range(C):
        for j in range(3):
            r = resp_intra[color[c0] * 3 + j]               # (U, C, 3)
            self_blocks[:, c0, :, j] = r[:, c0]
            for f in range(3):
                for c in np.nonzero(cn[:, f] == c0)[0]:
                    face_blocks[:, c, f, :, j] = r[:, c]

    # cross: slot (c, f) sources element halo_src with child id src_c;
    # domain-boundary slots carry no linear cross coupling
    halo_src = np.asarray(L["halo_src"])                    # (U, nb)
    src_c = halo_src % C                                    # (U, nb)
    cross_blocks = np.zeros((U, nb, 3, 3))
    u_all = np.arange(U)
    for slot in range(nb):
        c, f = int(bnd_c[slot]), int(bnd_f[slot])
        r = resp_cross[f][:, :, c, :]                       # (3*ncol, U, 3)
        for j in range(3):
            cross_blocks[:, slot, :, j] = r[color[src_c[:, slot]] * 3 + j,
                                            u_all]

    _, _, _, _, _, _, intra_onehot, cross_onehot = _static_tables(L)
    return StencilData(
        self_blocks=self_blocks, face_blocks=face_blocks,
        cross_blocks=cross_blocks, c_aff=c_aff, halo_src=halo_src,
        bnd_c=bnd_c.astype(np.int32), bnd_f=bnd_f.astype(np.int32),
        intra_onehot=intra_onehot, cross_onehot=cross_onehot)


def _static_tables(L: dict):
    """Static index sets of one level."""
    U = int(L["M"].shape[0])
    C = int(L["updown"].shape[0])
    cn = splitting.child_neighbors(L["s"])                  # (C, 3)
    bnd_c, bnd_f = np.nonzero(cn < 0)
    nb = len(bnd_c)
    intra_onehot = np.zeros((3, C, C))
    cross_onehot = np.zeros((3, C, nb))
    for c in range(C):
        for f in range(3):
            if cn[c, f] >= 0:
                intra_onehot[f, c, cn[c, f]] = 1.0
    for slot, (c, f) in enumerate(zip(bnd_c, bnd_f)):
        cross_onehot[f, c, slot] = 1.0
    halo_src = np.asarray(L["halo_src"])                    # (U, nb)
    return U, C, cn, bnd_c, bnd_f, halo_src, intra_onehot, cross_onehot


def build_stencil(L: dict, phys, dt: float, theta: float) -> StencilData:
    """Closed-form block stencil of the DG operator from one level's host
    tables (``models.semi.build_problem``), in the level's own precision:
    f32 tables give f32 self blocks, as in the JAX package.

      self blocks   = mass/dt + volume terms + the element's own side of the
                      surface terms (+ the Neumann-mirror income coupling)
      face blocks   = the neighbor side of the surface terms
      c_aff         = theta * (Dirichlet-ghost terms at T = 0)
    """
    U, C, cn, bnd_c, bnd_f, halo_src, intra_oh, cross_oh = _static_tables(L)
    nb = len(bnd_c)
    f64 = lambda key: np.asarray(L[key])
    ein = functools.partial(np.einsum, optimize=True)
    M, D, K = f64("M"), f64("D"), f64("K")
    face_sn, sn, sdet = f64("face_sn"), f64("sn"), f64("sdet")
    snorm, nx1, inv_dx = f64("snorm"), f64("nx1"), f64("inv_dx")
    diff_on, bc_dense = f64("diff_on"), f64("bc_dense")
    ud = f64("updown")                                      # (C,)
    neu = np.asarray(L["neu_mask"])                         # (U, C, 3) bool
    neigh = np.asarray(L["neigh_elem"])                     # (U, C, 3)
    interior = neigh >= 0
    fn = splitting.CHILD_FACE_NODES
    k = float(phys.k)
    eta = float(phys.penalty_factor)
    u_vec = np.asarray(phys.u, M.dtype)

    # geometry in child convention
    ud_b = ud[None, :, None, None]
    snorm_c = snorm[:, None] * ud_b[..., None]              # (U, C, 3f, g, 2)
    sdet_b = np.broadcast_to(sdet[:, None], (U, C, 3, sdet.shape[-1]))
    nxc = nx1[:, None] * (2.0 ** L["s"]) * ud_b             # (U, C, 2, nloc)

    # -- self blocks ---------------------------------------------------------
    A = np.broadcast_to(M[:, None] / dt, (U, C, 3, 3)).copy()
    if phys.diffusion:
        A += theta * D[:, None]
    if phys.advection:
        A -= theta * ud[None, :, None, None] * K[:, None]
    if phys.surface_terms and phys.diffusion:
        S0 = ein("fgi,fgj,ufg->ufij", face_sn, face_sn, sdet)
        A += (theta * eta * k
              * ein("ucf,ufij->ucij", inv_dx * diff_on, S0))
        if phys.sip_consistency:
            nn_ = ein("ucfgd,ucdj->ucfgj", snorm_c, nxc)
            w_face = np.where(interior, 0.5, 1.0) * diff_on
            cons = ein("fgi,ufg,ucfgj,ucf->ucij", face_sn, sdet, nn_,
                       w_face)
            A -= theta * k * (cons + np.swapaxes(cons, -1, -2))
    if phys.surface_terms and phys.advection:
        un = ein("ucfgd,d->ucfg", snorm_c, u_vec)
        income = 0.5 + 0.5 * np.sign(-un)
        A += theta * ein("fgi,ucfg,fgj->ucij", face_sn,
                         un * sdet_b * (1.0 - income), face_sn)
        # Neumann mirror: t2 = own trace, so the income flux couples back
        # to my own face nodes
        if neu.any():
            mir = ein("fgi,ucfg,gk->ucfik", face_sn,
                      un * sdet_b * income * neu[..., None], sn)
            for f in range(3):
                for kk in range(2):
                    A[:, :, :, fn[f, kk]] += theta * mir[:, :, f, :, kk]

    # -- neighbor blocks -----------------------------------------------------
    B = np.zeros((U, C, 3, 3, 3))
    if phys.surface_terms:
        perm = np.asarray(L["neigh_perm"])                  # (U, C, 3, 2)
        Pm = np.zeros((U, C, 3, 2, 3))
        for kk in range(2):
            np.put_along_axis(Pm[:, :, :, kk], perm[..., kk, None], 1.0,
                              axis=-1)
        S2 = ein("fgi,gk,ucfg->ucfik", face_sn, sn, sdet_b)
        if phys.diffusion:
            B -= (theta * eta * k
                  * ein("ucf,ucfik,ucfkj->ucfij", inv_dx * diff_on,
                        S2, Pm))
            if phys.sip_consistency:
                flat = nxc.reshape(U * C, 2, 3)
                safe = np.where(interior, neigh,
                                np.arange(U * C).reshape(U, C, 1))
                nxc2 = flat[safe]                           # (U, C, 3, 2, 3)
                nn2 = ein("ucfgd,ucfdj->ucfgj", snorm_c, nxc2)
                B -= 0.5 * theta * k * ein(
                    "fgi,ucfg,ucfgj->ucfij", face_sn,
                    sdet_b * diff_on[..., None], nn2)
                nxn = ein("ucdi,ucfgd->ucfgi", nxc, snorm_c)
                B += theta * k * ein(
                    "ucf,ucfgi,gk,ucfg,ucfkj->ucfij", 0.5 * diff_on, nxn,
                    sn, sdet_b, Pm)
        if phys.advection:
            un = ein("ucfgd,d->ucfg", snorm_c, u_vec)
            income = 0.5 + 0.5 * np.sign(-un)
            B += theta * ein("fgi,ucfg,gk,ucfkj->ucfij", face_sn,
                             un * sdet_b * income, sn, Pm)
        B *= interior[..., None, None]

    face_blocks = B * (cn >= 0)[None, :, :, None, None]
    cross_blocks = (B[:, bnd_c, bnd_f] if nb
                    else np.zeros((U, 0, 3, 3)))

    # -- Dirichlet affine: theta * spatial operator at T = 0 with ghosts ------
    c_aff = np.zeros((U, C, 3))
    if phys.surface_terms:
        dirich = (~interior) & (~neu)                       # (U, C, 3)
        t2b = np.where(dirich[..., None], bc_dense, 0.0)    # (U, C, 3, 2)
        t2_sgi = ein("gk,ucfk->ucfg", sn, t2b)
        if phys.diffusion:
            jump = -t2_sgi * sdet_b * diff_on[..., None]
            c_aff += eta * k * ein("fgi,ucf,ucfg->uci", face_sn,
                                   inv_dx, jump)
            if phys.sip_consistency:
                w_face = np.where(interior, 0.5, 1.0)
                nxn = ein("ucdi,ucfgd->ucfgi", nxc, snorm_c)
                c_aff -= k * ein("ucf,ucfgi,ucfg->uci", w_face, nxn,
                                 jump)
        if phys.advection:
            un = ein("ucfgd,d->ucfg", snorm_c, u_vec)
            income = 0.5 + 0.5 * np.sign(-un)
            c_aff += ein("fgi,ucfg->uci", face_sn,
                         un * sdet_b * income * t2_sgi)
        c_aff *= theta

    return StencilData(
        self_blocks=np.asarray(A), face_blocks=face_blocks,
        cross_blocks=cross_blocks, c_aff=c_aff, halo_src=halo_src,
        bnd_c=bnd_c.astype(np.int32), bnd_f=bnd_f.astype(np.int32),
        intra_onehot=intra_oh, cross_onehot=cross_oh)


def _split_depth(C: int) -> int:
    return int(round(np.log(C) / np.log(4))) if C > 1 else 0


def to_dense(data: StencilData) -> np.ndarray:
    """The full (U*C*3, U*C*3) matrix of a level, in the standard flat order
    ((u*C + c)*3 + i)."""
    U, C = data.self_blocks.shape[:2]
    E = U * C
    A = np.zeros((E, 3, E, 3))
    e_all = np.arange(E)
    A[e_all, :, e_all, :] = data.self_blocks.reshape(E, 3, 3)
    eids = e_all.reshape(U, C)
    cn = splitting.child_neighbors(_split_depth(C))
    for c in range(C):
        for f in range(3):
            if cn[c, f] >= 0:
                A[eids[:, c], :, eids[:, cn[c, f]], :] += \
                    data.face_blocks[:, c, f]
    for slot in range(len(data.bnd_c)):
        rows = eids[:, data.bnd_c[slot]]
        cols = data.halo_src[:, slot]
        A[rows, :, cols, :] += data.cross_blocks[:, slot]
    return A.reshape(E * 3, E * 3)


def mul_blocks(B_t, v_t):
    """B v for 3x3 blocks B (3, 3, C, U) and v (3, C, U) in transposed
    layout; v itself where B is None (the identity)."""
    return v_t if B_t is None else (B_t * v_t[None]).sum(dim=1)


def inv3x3(A: np.ndarray) -> np.ndarray:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co = np.empty_like(A)
    co[..., 0, 0] = e * i - f * h
    co[..., 0, 1] = c * h - b * i
    co[..., 0, 2] = b * f - c * e
    co[..., 1, 0] = f * g - d * i
    co[..., 1, 1] = a * i - c * g
    co[..., 1, 2] = c * d - a * f
    co[..., 2, 0] = d * h - e * g
    co[..., 2, 1] = b * g - a * h
    co[..., 2, 2] = a * e - b * d
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def lam_max_estimate(data: StencilData, iters: int = 12,
                     seed: int = 0) -> float:
    """Largest eigenvalue of D^-1 A by numpy power iteration from a seeded
    normal vector, with a 1.2 safety factor (Chebyshev amplifies anything
    beyond the interval, so overestimating is cheap)."""
    U, C = data.self_blocks.shape[:2]
    nb = data.cross_blocks.shape[1]
    dinv = inv3x3(data.self_blocks)
    Sp = np.einsum("ucik,uckj->ucij", dinv, data.self_blocks)
    Fp = np.einsum("ucik,ucfkj->ucfij", dinv, data.face_blocks)
    Xp = (np.einsum("usik,uskj->usij", dinv[:, data.bnd_c],
                    data.cross_blocks) if nb else data.cross_blocks)
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(U, C, 3))

    bnd_c = np.asarray(data.bnd_c)
    cn = splitting.child_neighbors(_split_depth(C))
    cn_safe = np.where(cn >= 0, cn, np.arange(C)[:, None])  # (C, 3)

    def apply_np(x):
        out = np.einsum("ucij,ucj->uci", Sp, x, optimize=True)
        for f in range(3):
            xg = x[:, cn_safe[:, f], :]
            xg = np.where((cn[:, f] >= 0)[None, :, None], xg, 0.0)
            out += np.einsum("ucij,ucj->uci", Fp[:, :, f], xg,
                             optimize=True)
        if nb:
            src = x.reshape(U * C, 3)[data.halo_src]        # (U, nb, 3)
            cs = np.einsum("usij,usj->usi", Xp, src)        # (U, nb, 3)
            # each slot's term into its strip child, the slots of one
            # child summed first and in slot order
            cross = np.zeros_like(out)
            np.add.at(cross, (slice(None), bnd_c), cs)
            out += cross
        return out

    for _ in range(iters):
        w = apply_np(v)
        v = w / np.linalg.norm(w)
    return 1.2 * float(np.linalg.norm(apply_np(v)))


class StencilOperator(nn.Module):
    """One level's block stencil on a device, in the transposed layout:
    state ``x_t`` is (3, C, U), coefficients are (..., C, U) planes.

    Buffers (``dtype`` on ``device``):
      S_t, Dinv_t (3i, 3j, C, U)        self blocks and their inverses
      Fp_t        (3f, 3i, 3j, C, U)    D^-1 F, F the face blocks
      Xp_t        (3i, 3j, nb, U)       D^-1 X, X the cross-macro slot blocks
      c_aff_t     (3, C, U)             Dirichlet-ghost affine vector
      intra_rows  (3f, C) int32         child across face f (self on the
                                        macro boundary, where F is zero)
      src_cu      (nb, U) int32         source of slot s at macro u as an
                                        offset c_src*U + u_src in a (C, U)
                                        plane
      bnd_c       (nb,) int32           child of each slot
      slot_ptr    (C+1,) int32, slot_idx (nb,) int32: the slots of child c
                                        are slot_idx[slot_ptr[c]:slot_ptr[c+1]]
    """

    def __init__(self, data: StencilData, dtype: torch.dtype,
                 device: torch.device | str):
        super().__init__()
        if getattr(data, "slot_mf", None) is not None:
            raise ValueError("macro-packed stencil data is not supported: "
                             "the port runs coarse levels unpacked")
        U, C = data.self_blocks.shape[:2]
        nb = data.cross_blocks.shape[1]
        self.U, self.C, self.nb = U, C, nb
        self._data = data
        # the checked step's site of this operator (utils.debugging.attach)
        self.sanitizer = None
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype

        # premultiplied-smoother form: z = D^-1 (b - A x) with D = self
        # block; folding D^-1 into the neighbor blocks removes D from the
        # relaxation round
        Dinv = inv3x3(data.self_blocks)                          # (U,C,3,3)
        Fp = np.einsum("ucik,ucfkj->ucfij", Dinv, data.face_blocks)
        Xp = (np.einsum("usik,uskj->usij", Dinv[:, data.bnd_c],
                        data.cross_blocks) if nb else data.cross_blocks)
        # halo_src is a standard-layout flat index u*C + c; the state is
        # (3, C, U), so a slot's source sits at c_src*U + u_src of a plane
        hs = np.asarray(data.halo_src)
        src_c, src_u = hs % C, hs // C                           # (U, nb)
        cn = splitting.child_neighbors(_split_depth(C))
        intra_rows = np.where(cn >= 0, cn, np.arange(C)[:, None]).T
        bnd_c = np.asarray(data.bnd_c)
        slot_idx = np.argsort(bnd_c, kind="stable")
        slot_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(bnd_c, minlength=C))])

        def buf(name, a, dt=np_dtype):
            self.register_buffer(name, torch.tensor(
                np.ascontiguousarray(np.asarray(a, dt)), device=device))

        buf("S_t", data.self_blocks.transpose(2, 3, 1, 0))
        buf("c_aff_t", data.c_aff.transpose(2, 1, 0))
        buf("Fp_t", Fp.transpose(2, 3, 4, 1, 0))
        buf("Xp_t", Xp.transpose(2, 3, 1, 0))
        buf("Dinv_t", Dinv.transpose(2, 3, 1, 0))
        buf("intra_rows", intra_rows, np.int32)
        buf("src_cu", (src_c * U + src_u).T, np.int32)
        buf("bnd_c", bnd_c, np.int32)
        buf("slot_ptr", slot_ptr, np.int32)
        buf("slot_idx", slot_idx, np.int32)

    def lam_max_estimate(self, iters: int = 12, seed: int = 0) -> float:
        """``lam_max_estimate`` of this level's host stencil (numpy, no
        device work)."""
        return lam_max_estimate(self._data, iters, seed)

    # -- application (plain PyTorch) -----------------------------------------
    def _apply_planes(self, x_t):
        """D^-1 (A - D) x: the premultiplied neighbor contribution
        sum_f Fp[f] x_nb(f) + cross-slot terms as a (3, C, U) tensor, by
        direct index gathers."""
        xg = x_t[:, self.intra_rows.long()]                 # (3j, 3f, C, U)
        off = (self.Fp_t * xg.transpose(0, 1)[:, None]).sum(dim=(0, 2))
        if self.nb:
            sv = x_t.reshape(3, -1)[:, self.src_cu.long()]  # (3j, nb, U)
            cs = (self.Xp_t * sv[None]).sum(dim=1)          # (3i, nb, U)
            cross = torch.zeros_like(off).index_add_(1, self.bnd_c.long(),
                                                     cs)
            off = off + cross
        return off

    def apply(self, x_t, with_bc: bool):
        """A x (+ Dirichlet affine when with_bc) in transposed layout, as
        D (x + D^-1 (A - D) x) from the premultiplied planes."""
        out = self.mul_self(x_t + self._apply_planes(x_t))
        return out + self.c_aff_t if with_bc else out

    def solve_diag(self, r_t):
        """D^-1 r in transposed layout."""
        return mul_blocks(self.Dinv_t, r_t)

    def mul_self(self, z_t):
        """D z (self blocks): turns a phase's z = D^-1 (b - A x) into the
        residual b - A x."""
        return mul_blocks(self.S_t, z_t)

    def _z(self, x_t, bp):
        """z = D^-1 (b - A x) = bp - x - D^-1 (A - D) x: one relaxation
        round's update direction, the plain version of kernel K1's round."""
        return bp - x_t - self._apply_planes(x_t)

    def _bp(self, b_t, with_bc: bool):
        """Premultiplied right-hand side D^-1 (b - c_aff)."""
        return self.solve_diag(b_t - self.c_aff_t if with_bc else b_t)

    # -- the JAX package's smoothing methods, as one K1 phase each ----------
    def smooth_chebyshev(self, x_t, b_t, roots, sweeps: int, with_bc: bool):
        """``sweeps`` sweeps of x <- x + z / r over ``roots``, as one
        relaxation phase (``ops.phase.phase``: kernel K1 on the card)."""
        from .phase import phase
        coefs = [1.0 / r for r in roots] * sweeps
        return phase(self, x_t, self._bp(b_t, with_bc), coefs, False)[0]

    def smooth_jacobi(self, x_t, b_t, omega: float, sweeps: int,
                      with_bc: bool):
        """``sweeps`` sweeps of x <- x + omega z, as one relaxation phase
        (kernel K1 on the card)."""
        from .phase import phase
        return phase(self, x_t, self._bp(b_t, with_bc), [omega] * sweeps,
                     False)[0]

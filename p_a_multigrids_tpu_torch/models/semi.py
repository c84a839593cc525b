"""Semi-structured geometric-multigrid transport solver (modes 7 and 9;
modes 2-6 through ``models.transport``).

Port of the stencil path of the JAX package's ``models/semi.py``:

- the host half (``manufactured_*``, ``_face_geometry``, ``_penalty_*``,
  ``build_problem``) is numpy copied from it and yields the same tables bit
  for bit, cast to the run dtype before the stencil is assembled;
- ``flat_gather``, ``neighbor_trace``, ``apply_spatial``, ``apply_A`` and
  ``diag_blocks_A`` are the matrix-free operator in plain PyTorch on a
  level's device tables (``level_tensors``): the theta-scheme's explicit
  part and the assembled operator of ``models.semi_assembled`` come from
  them.
- ``SemiSolver`` is an ``nn.Module`` running the transposed-layout (3, C, U)
  theta-scheme step by V-cycles or by V-cycle-preconditioned PCG
  (BiCGStab under advection) on one device.  On the stencil path every
  Chebyshev or block-Jacobi smoothing phase, residual and operator apply is
  a call of the relaxation-phase kernel K1 (``ops.phase.phase``), and each
  level transfer of the geometric cycle one launch of the transfer kernels
  (``ops.transfer``: the restriction forms the residual from a phase's z,
  the prolongation adds the correction); the point smoothers (Jacobi,
  Richardson, colored Gauss-Seidel, direct) run ``ops.smoothers`` over
  K1's zero-round apply.  On a CPU tensor a kernel call runs the plain
  PyTorch version.  On the card the Krylov preconditioner
  and the bare time step's cycles of a geometric-only hierarchy with K1
  phases each replay as one CUDA graph (``_precond_t``, ``_cycles_t``,
  ``ops.cuda_graph``).
- Above ``stencil_max_children`` children a macro (n_split >= 8 by
  default; the JAX package's cap of 4,096 stopped at n_split 7), or with
  ``stencil_operator=False``, the operator is ``ops.fused.FusedOperator``
  (or ``apply_A``) in plain PyTorch, as it was XLA on the TPU.
- The smoothed-aggregation hierarchy (``ops.agg``) corrects the finest
  level (``amg=True``) or continues below a geometric coarsest too large
  for the dense inverse (``coarse_agg``); each of its block-row operators is
  a call of kernel K2 (``ops.spmv``).
- The coarse levels are assembled geometrically or, with
  ``coarse_operator="galerkin"``, as P^T A P (``ops.galerkin``), at any
  split depth (the level sweep runs n_split 5: C = 1024 children per
  macro; the scaling study's deepest row n_split 7, C = 16,384, whose
  fine phases K1 runs in its streaming tier).

With ``debug`` the step is a checked step (``utils.debugging``): the
index tables are range-checked when the solver is built, the state is
asserted finite before each step, K1 and K2 run their checked builds on
the card, and the error record is read once a step.
"""

from __future__ import annotations

import dataclasses
import functools
import typing
import warnings

import numpy as np
import torch
from torch import nn

from ..config import Physics, SemiConfig, Solver
from ..mesh import geometry, semi, splitting
from ..mesh.topology import MacroMesh
from ..ops import agg, cuda_graph, galerkin, krylov, smoothers, transfer
from ..ops import local_matrices as lm
from ..ops.fused import FusedOperator, from_t, to_t
from ..ops.phase import CHECKED as K1_CHECKED, KERNEL as K1_KERNEL, phase
from ..ops.phase import watch as watch_k1
from ..ops.stencil import (StencilOperator, build_stencil, lam_max_estimate,
                           mul_blocks, probe_stencil, to_dense)
from ..ops.transfer import prolong_t, restrict_t
from ..utils import debugging, shape_functions, tracing


def manufactured_solution(x, y):
    """boundary(x,y) = sin(x+y)."""
    return np.sin(x + y)


def manufactured_source(x, y, k):
    """+2k sin(x+y) = -k*laplace(sin(x+y))."""
    return 2.0 * k * manufactured_solution(x, y)


# ---------------------------------------------------------------------------
# setup (host numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SemiProblem:
    grid: semi.SemiGrid
    cfg: SemiConfig
    levels: list[dict]          # host tables per level (0 = finest)
    coords_fine: np.ndarray     # (U, C, 2, 3) finest child node coords
    analytical: np.ndarray      # (U, C, 3) in the run dtype

    @property
    def num_macro(self):
        return self.grid.num_macro


def _face_geometry(mesh: MacroMesh, ngi: int, sngi: int):
    """Macro-element geometry in the child-face convention: detwei0 (U,
    ngi), nx0 (U, ngi, 2, 3), sdet0 (U, 3, sngi) edge |J|*w and snorm0 (U,
    3, sngi, 2) outward unit normals (for an up child)."""
    n, nlx, w = shape_functions.tri_p1(ngi)
    detwei0, nx0, _ = geometry.tri_det_nlx(mesh.X, nlx, w)

    sn, snlx, sw = shape_functions.edge_p1(sngi)
    U = mesh.num_elements
    centroid = mesh.X.mean(axis=2)                       # (U, 2)
    sdet0 = np.zeros((U, 3, sngi))
    snorm0 = np.zeros((U, 3, sngi, 2))
    for f in range(3):
        a, b = splitting.CHILD_FACE_NODES[f]
        xsl = mesh.X[:, :, [a, b]]                       # (U, 2, 2)
        t = np.einsum("gl,ubl->ugb", snlx[:, 0, :], xsl)
        tnorm = np.linalg.norm(t, axis=-1)               # (U, sngi)
        sdet0[:, f] = tnorm * sw
        nrm = np.stack([t[..., 1], -t[..., 0]], axis=-1) / tnorm[..., None]
        approx = xsl.mean(axis=2) - centroid             # (U, 2)
        sign = np.sign(np.sum(nrm * approx[:, None, :], axis=-1))
        sign[sign == 0] = 1.0
        snorm0[:, f] = nrm * sign[..., None]
    return detwei0, nx0, sdet0, snorm0


def _penalty_dx(mesh: MacroMesh, lvl: semi.SemiLevel) -> np.ndarray:
    """Center-to-center distances for the k/dx penalty, per (u, c, face):
    child-centroid distance inside a macro, macro centroid distance / 2**s
    across macros, (macro centroid to face midpoint) / 2**s on the domain
    boundary."""
    U = mesh.num_elements
    n = lvl.n
    C = 4 ** n
    coords = splitting.child_coords(mesh.X, n)           # (U, C, 2, 3)
    cent = coords.mean(axis=3)                           # (U, C, 2)
    cent_flat = cent.reshape(U * C, 2)
    neigh = lvl.neigh_elem                               # (U, C, 3)
    safe = np.maximum(neigh, 0)
    d_child = np.linalg.norm(
        cent[:, :, None, :] - cent_flat[safe], axis=-1)  # (U, C, 3)

    macro_cent = mesh.X.mean(axis=2)                     # (U, 2)
    cf2mf = splitting.CHILD2MACRO_FACE
    d_macro = np.zeros((U, 3))
    for mf in range(3):
        v = mesh.neig[:, mf]
        safe_v = np.maximum(v, 0)
        dd = np.linalg.norm(macro_cent - macro_cent[safe_v], axis=-1)
        a, b = splitting.MACRO_FACE_NODES[mf]
        mid = 0.5 * (mesh.X[:, :, a] + mesh.X[:, :, b])
        d_bnd = np.linalg.norm(macro_cent - mid, axis=-1)
        d_macro[:, mf] = np.where(v >= 0, dd, d_bnd) / (2 ** n)

    intra = np.broadcast_to(
        (splitting.child_neighbors(n) >= 0)[None], (U, C, 3))
    dx = np.where(intra, d_child, d_macro[:, None, :][:, :, cf2mf])
    return np.maximum(dx, 1e-300)


def _penalty_face_over_area(mesh: MacroMesh, lvl: semi.SemiLevel,
                            sdet0: np.ndarray) -> np.ndarray:
    """Shape-robust SIP penalty scale: max over the two incident elements of
    |F| / |E| at child scale -> (U, C, 3)."""
    U = mesh.num_elements
    n = lvl.n
    C = 4 ** n
    area_macro = np.abs(geometry.tri_area(mesh.X))        # (U,)
    child_area = area_macro / (4.0 ** n)                  # (U,)
    face_len = sdet0.sum(axis=2) / (2.0 ** n)             # (U, 3) child scale
    my_ratio = face_len[:, None, :] / child_area[:, None, None]  # (U, 1, 3)
    my_ratio = np.broadcast_to(my_ratio, (U, C, 3)).copy()
    neigh_u = np.maximum(lvl.neigh_elem, 0) // C          # (U, C, 3)
    nb_ratio = face_len[:, None, :] / child_area[neigh_u]
    nb_ratio = np.where(lvl.neigh_elem >= 0, nb_ratio, my_ratio)
    return np.maximum(my_ratio, nb_ratio)


def build_problem(mesh: MacroMesh, cfg: SemiConfig) -> SemiProblem:
    """Host tables of every level, pre-cast to the run dtype (the stencil
    is then assembled in that precision, as in the JAX package); the
    set-up stage ``pamg.setup.problem``."""
    with tracing.stage("pamg.setup.problem"):
        return _problem_tables(mesh, cfg)


def _problem_tables(mesh: MacroMesh, cfg: SemiConfig) -> SemiProblem:
    grid = semi.build_grid(mesh, cfg.n_split, cfg.multi_levels)
    dtype = np.dtype(cfg.dtype)
    ngi, sngi = 3, 2
    n_tab, nlx, w = shape_functions.tri_p1(ngi)
    sn_tab, _, sw = shape_functions.edge_p1(sngi)
    ft = shape_functions.tri_face_tables(ngi, sngi)
    detwei0, nx0, sdet0, snorm0 = _face_geometry(mesh, ngi, sngi)
    U = mesh.num_elements
    k = cfg.physics.k
    u_vec = np.asarray(cfg.physics.u)

    # macro-scale stencils (children reuse them via scalings)
    M0 = lm.mass(n_tab, detwei0)
    ml0 = lm.lumped_mass(n_tab, detwei0)
    D0 = lm.diffusion_volume(nx0, detwei0, k)
    K0 = lm.advection_stiffness(
        n_tab, nx0, detwei0,
        np.broadcast_to(u_vec, detwei0.shape + (2,)))

    levels = []
    for i, lvl in enumerate(grid.levels):
        s = lvl.n
        C = 4 ** s
        scale_m = 1.0 / 4.0 ** s
        scale_k = 1.0 / 2.0 ** s
        if cfg.physics.sip_consistency:
            inv_dx = _penalty_face_over_area(mesh, lvl, sdet0)
            # Galerkin matching: a coarse function prolonged to the fine
            # grid is penalized with the FINE |F|/|E| coefficient, 2**i
            # times the coarse level's own ratio
            inv_dx = inv_dx * (2.0 ** i)
        else:
            inv_dx = 1.0 / _penalty_dx(mesh, lvl)
        # Dirichlet ghost endpoint values at boundary faces (finest level
        # only; coarse correction equations use homogeneous ghosts)
        bc_fn = cfg.fns.bc
        if bc_fn is None and cfg.manufactured:
            bc_fn = manufactured_solution
        bc_vals = np.zeros((len(lvl.bc_elem), 2))
        if bc_fn is not None and i == 0 and len(lvl.bc_elem):
            bc_vals = np.broadcast_to(np.asarray(
                bc_fn(lvl.bc_coords[:, :, 0], lvl.bc_coords[:, :, 1]),
                np.float64), (len(lvl.bc_elem), 2))
        neu_mask = np.zeros((U, C, 3), bool)
        if cfg.fns.neumann is not None and len(lvl.bc_elem):
            mid = lvl.bc_coords.mean(axis=1)             # (nb, 2)
            is_neu = np.asarray(cfg.fns.neumann(mid[:, 0], mid[:, 1]), bool)
            flat = np.zeros((U * C, 3), bool)
            flat[lvl.bc_elem, lvl.bc_face] = is_neu
            neu_mask = flat.reshape(U, C, 3)
        diff_on = np.where(neu_mask, 0.0, 1.0)
        bc_dense = np.zeros((U * C, 3, 2))
        if len(lvl.bc_elem):
            bc_dense[lvl.bc_elem, lvl.bc_face] = bc_vals
        bc_dense = bc_dense.reshape(U, C, 3, 2)
        L = dict(
            n=np.asarray(n_tab, dtype),
            sn=np.asarray(sn_tab, dtype),
            face_sn=np.asarray(ft["face_sn"], dtype),
            M=np.asarray(M0 * scale_m, dtype),
            ml=np.asarray(ml0 * scale_m, dtype),
            D=np.asarray(D0, dtype),
            K=np.asarray(K0 * scale_k, dtype),
            nx1=np.asarray(nx0[:, 0], dtype),    # (U, 2, nloc) P1 gradients
            sdet=np.asarray(sdet0 * scale_k, dtype),
            snorm=np.asarray(snorm0, dtype),
            updown=np.asarray(lvl.updown, dtype),
            neigh_elem=np.asarray(lvl.neigh_elem),
            neigh_perm=np.asarray(lvl.neigh_perm),
            bc_elem=np.asarray(lvl.bc_elem),
            bc_face=np.asarray(lvl.bc_face),
            bc_vals=np.asarray(bc_vals, dtype),
            bc_dense=np.asarray(bc_dense, dtype),
            inv_dx=np.asarray(inv_dx, dtype),
            neu_mask=np.asarray(neu_mask),
            diff_on=np.asarray(diff_on, dtype),
        )
        # intra-macro child table and the cross-macro source of every
        # boundary-strip slot (halo_src: flat u*C + c, the element itself
        # on a domain-boundary face)
        cn = splitting.child_neighbors(s)                # (C, 3)
        intra_idx = np.where(cn >= 0, cn, np.arange(C)[:, None])
        bnd_c, bnd_f = np.nonzero(cn < 0)
        nb = len(bnd_c)
        slot_of = np.zeros((C, 3), np.int64)
        slot_of[bnd_c, bnd_f] = np.arange(nb)
        self_flat = (np.arange(U)[:, None] * C + bnd_c[None, :])
        halo_src = np.asarray(lvl.neigh_elem)[:, bnd_c, bnd_f]
        halo_src = np.where(halo_src >= 0, halo_src, self_flat)
        L.update(intra_idx=np.asarray(intra_idx),
                 intra_mask=np.asarray(cn >= 0),
                 slot_of=np.asarray(slot_of),
                 halo_src=np.asarray(halo_src),
                 C=C, s=s)
        levels.append(L)

    coords_fine = splitting.child_coords(mesh.X, cfg.n_split)
    xf, yf = coords_fine[:, :, 0], coords_fine[:, :, 1]
    src_fn = cfg.fns.source
    ana_fn = cfg.fns.analytical
    if cfg.manufactured:
        src_fn = src_fn or (lambda x, y: manufactured_source(x, y, k))
        ana_fn = ana_fn or manufactured_solution
    src = (np.broadcast_to(np.asarray(src_fn(xf, yf), np.float64),
                           xf.shape) if src_fn else np.zeros(xf.shape))
    ana = (np.broadcast_to(np.asarray(ana_fn(xf, yf), np.float64),
                           xf.shape) if ana_fn else np.zeros(xf.shape))
    levels[0]["source"] = np.asarray(src, dtype)
    return SemiProblem(grid=grid, cfg=cfg, levels=levels,
                       coords_fine=coords_fine,
                       analytical=np.asarray(ana, dtype))


# ---------------------------------------------------------------------------
# operator (plain PyTorch on a level's device tables)
# ---------------------------------------------------------------------------

# the host tables of a level that the operator functions below read
OPERATOR_KEYS = ("M", "ml", "D", "K", "updown", "neigh_elem", "neigh_perm",
                 "bc_dense", "neu_mask", "face_sn", "sn", "sdet", "snorm",
                 "nx1", "inv_dx", "diff_on")


def level_tensors(L: dict, device) -> dict:
    """The tables of one level (``build_problem``'s host arrays, already in
    the run dtype) that ``apply_spatial``, ``apply_A``, ``diag_A``,
    ``diag_blocks_A`` and ``models.semi_assembled`` read, as tensors on
    ``device``; index tables as int64, "s" as an int."""
    out = {"s": int(L["s"])}
    for key in OPERATOR_KEYS:
        a = np.asarray(L[key])
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        out[key] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return out


def flat_gather(L: dict, X: torch.Tensor) -> torch.Tensor:
    """X (U, C, ...) -> (U, C, 3, ...): entry [u, c, f] is X of the element
    across face f, or X of (u, c) itself on a domain-boundary face (one
    index gather; the JAX package's ``structured_gather`` gives the same
    values)."""
    U, C = X.shape[:2]
    flat = X.reshape(U * C, *X.shape[2:])
    self_flat = torch.arange(U * C, device=X.device).reshape(U, C, 1)
    safe = torch.where(L["neigh_elem"] >= 0, L["neigh_elem"], self_flat)
    return flat[safe]


def structured_gather(L: dict, X: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``structured_gather`` (its split of the gather
    into intra-macro and strip faces, for the TPU's lowering): the same
    values, by ``flat_gather``'s one index gather."""
    return flat_gather(L, X)


def neighbor_trace(L: dict, T: torch.Tensor, with_bc: bool,
                   gather=flat_gather) -> torch.Tensor:
    """T2 (U, C, 3, 2): for each face f, the neighbor's values at the
    physical positions of my two face nodes; domain-boundary faces get the
    Dirichlet ghost values (zero without ``with_bc``), no-flux faces
    (``neu_mask``) mirror my own trace.  ``gather`` is ``flat_gather`` or a
    masked version of it (``ops.stencil.probe_stencil``)."""
    Tn = gather(L, T)                                    # (U, C, 3, 3)
    T2 = torch.gather(Tn, -1, L["neigh_perm"])           # (U, C, 3, 2)
    interior = (L["neigh_elem"] >= 0)[..., None]
    bc = (L["bc_dense"] if with_bc
          else torch.zeros_like(L["bc_dense"])).to(T.dtype)
    own = T[:, :, torch.as_tensor(splitting.CHILD_FACE_NODES,
                                  device=T.device)]      # (U, C, 3, 2)
    bc = torch.where(L["neu_mask"][..., None], own, bc)
    return torch.where(interior, T2, bc)


def _child_geometry(L: dict):
    """(updown (1, C, 1, 1), outward child normals snorm (U, C, 3, sngi,
    2), P1 gradients nxc (U, C, 2, nloc)) in the child convention: updown
    flips the macro geometry of the down children."""
    ud = L["updown"][None, :, None, None]
    snorm = L["snorm"][:, None] * ud[..., None]
    nxc = L["nx1"][:, None] * (2.0 ** L["s"]) * ud
    return ud, snorm, nxc


def apply_spatial(L: dict, phys: Physics, T: torch.Tensor,
                  with_bc: bool, gather=flat_gather) -> torch.Tensor:
    """L(T) = D T - updown K T + surface terms (upwind advection flux and
    symmetric interior penalty diffusion), T (U, C, 3)."""
    ein = torch.einsum
    out = torch.zeros_like(T)
    if phys.diffusion:
        out = out + ein("uij,ucj->uci", L["D"], T)
    if phys.advection:
        Kt = ein("uij,ucj->uci", L["K"], T)
        out = out - L["updown"][None, :, None] * Kt
    if phys.surface_terms:
        _, snorm, nxc = _child_geometry(L)
        T2 = neighbor_trace(L, T, with_bc, gather)       # (U, C, 3, 2)
        # traces at the surface quadrature points
        t_sgi = ein("fgi,uci->ucfg", L["face_sn"], T)
        t2_sgi = ein("gk,ucfk->ucfg", L["sn"], T2)
        sdet = L["sdet"][:, None]                        # (U, 1, 3, sngi)
        if phys.diffusion:
            k = phys.k
            # no diffusive surface terms on no-flux faces (the advective
            # flux below keeps the plain sdet)
            sdet_d = sdet * L["diff_on"][..., None]
            jump = (t_sgi - t2_sgi) * sdet_d             # (U, C, 3, sngi)
            out = out + ein("fgi,ucf,ucfg->uci", L["face_sn"],
                            phys.penalty_factor * k * L["inv_dx"], jump)
            if phys.sip_consistency:
                # piecewise-constant P1 gradients, the neighbor's by gather
                G = ein("ucdl,ucl->ucd", nxc, T)         # (U, C, 2)
                G2 = gather(L, G)                        # (U, C, 3, 2)
                gavg_n = 0.5 * ein("ucfd,ucfgd->ucfg", G[:, :, None] + G2,
                                   snorm)
                # consistency: -sum_g face_sn_i k {grad t . n} sdet
                out = out - k * ein("fgi,ucfg->uci", L["face_sn"],
                                    gavg_n * sdet_d)
                # symmetry: -w k (grad N_i . n) sum_g (t - t2) sdet, w = 1/2
                # on interior faces, 1 on boundary faces (Nitsche)
                w_face = torch.where(L["neigh_elem"] < 0, 1.0,
                                     0.5).to(T.dtype)
                nxn = ein("ucdi,ucfgd->ucfgi", nxc, snorm)
                out = out - k * ein("ucf,ucfgi,ucfg->uci", w_face, nxn,
                                    jump)
        if phys.advection:
            un = ein("ucfgd,d->ucfg", snorm,
                     torch.as_tensor(phys.u, dtype=T.dtype, device=T.device))
            # upwind switch: sign(0) = 0 gives a face tangent to u 1/2 of
            # each side, as in the JAX package
            income = 0.5 + 0.5 * torch.sign(-un)
            s_cont = un * sdet * ((1.0 - income) * t_sgi + income * t2_sgi)
            out = out + ein("fgi,ucfg->uci", L["face_sn"], s_cont)
    return out


def apply_A(L: dict, phys: Physics, dt: float, theta: float,
            T: torch.Tensor, with_bc: bool, gather=flat_gather
            ) -> torch.Tensor:
    """A(T) = M T / dt + theta L(T)."""
    Mt = torch.einsum("uij,ucj->uci", L["M"], T) / dt
    return Mt + theta * apply_spatial(L, phys, T, with_bc, gather)


def diag_A(L: dict, phys: Physics, dt: float, theta: float) -> torch.Tensor:
    """The point-relaxation diagonal (U, C, 3): lumped mass / dt + theta *
    (diag(D) + the penalty diagonal)."""
    U, C = L["M"].shape[0], L["updown"].shape[0]
    d = (L["ml"][:, None] / dt).expand(U, C, 3).to(L["M"].dtype)
    if phys.diffusion:
        d = d + theta * torch.diagonal(L["D"], dim1=-2, dim2=-1)[:, None]
    if phys.surface_terms and phys.diffusion:
        pen_diag = torch.einsum("fgi,fgi,ufg->ufi", L["face_sn"],
                                L["face_sn"], L["sdet"])  # (U, 3f, nloc)
        d = d + (theta * phys.penalty_factor * phys.k
                 * torch.einsum("ucf,ufi->uci", L["inv_dx"] * L["diff_on"],
                                pen_diag))
    return d.contiguous()


def diag_blocks_A(L: dict, phys: Physics, dt: float, theta: float
                  ) -> torch.Tensor:
    """The exact per-element diagonal blocks of A, (U, C, 3, 3): mass/dt,
    the volume terms and the element's own side of the surface terms."""
    ein = torch.einsum
    U, C = L["M"].shape[0], L["updown"].shape[0]
    A = (L["M"][:, None] / dt).expand(U, C, 3, 3)
    ud, snorm, nxc = _child_geometry(L)
    if phys.diffusion:
        A = A + theta * L["D"][:, None]
    if phys.advection:
        A = A - theta * ud * L["K"][:, None]
    if phys.surface_terms and phys.diffusion:
        k = phys.k
        S0 = ein("fgi,fgj,ufg->ufij", L["face_sn"], L["face_sn"], L["sdet"])
        A = A + (theta * phys.penalty_factor * k
                 * ein("ucf,ufij->ucij", L["inv_dx"] * L["diff_on"], S0))
        if phys.sip_consistency:
            nn_ = ein("ucfgd,ucdj->ucfgj", snorm, nxc)
            w_face = (torch.where(L["neigh_elem"] < 0, 1.0, 0.5).to(A.dtype)
                      * L["diff_on"])
            cons = ein("fgi,ufg,ucfgj,ucf->ucij", L["face_sn"], L["sdet"],
                       nn_, w_face)
            A = A - theta * k * (cons + cons.transpose(-1, -2))
    if phys.surface_terms and phys.advection:
        un = ein("ucfgd,d->ucfg", snorm,
                 torch.as_tensor(phys.u, dtype=A.dtype, device=A.device))
        income = 0.5 + 0.5 * torch.sign(-un)
        sdet = L["sdet"][:, None].expand(un.shape)
        # my-side upwind flux: sum_f,g face_sn_i un sdet (1-income) face_sn_j
        A = A + theta * ein("fgi,ucfg,fgj->ucij", L["face_sn"],
                            un * sdet * (1.0 - income), L["face_sn"])
    return A.contiguous()


# ---------------------------------------------------------------------------
# multigrid transfer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _transfer_tables(n_coarse: int):
    """Transfer tables between split depths n_coarse+1 and n_coarse:
    fine_of (Cc, 4) children of each coarse element (corners first),
    parent (Cf,) and pweights (Cf, 3, 3): the correction at fine node l is
    sum_k pweights[fc, l, k] * e_coarse[parent, k] (linear
    interpolation)."""
    fine_of = splitting.element_conversion(n_coarse)
    Cc = fine_of.shape[0]
    Cf = 4 ** (n_coarse + 1)
    cv, _ = splitting.child_lattice(n_coarse)
    fv, _ = splitting.child_lattice(n_coarse + 1)
    parent = np.zeros((Cf,), np.int32)
    for cc in range(Cc):
        parent[fine_of[cc]] = cc
    # the parent's vertices in fine units, (Cf, 3, 2)
    V = cv[parent].astype(float) * 2.0
    A = np.stack([V[:, 0] - V[:, 2], V[:, 1] - V[:, 2]], axis=2)  # (Cf, 2, 2)
    rhs = fv.astype(float) - V[:, 2:3]                   # (Cf, 3, 2)
    # one 2x2 solve a (fine child, local node), batched
    ab = np.linalg.solve(A[:, None], rhs[..., None])[..., 0]    # (Cf, 3, 2)
    pweights = np.concatenate(
        [ab, 1.0 - (ab[..., :1] + ab[..., 1:])], axis=-1)
    return fine_of, parent, pweights


def restrict_corner_average_t(r_fine_t, corners):
    """The Fortran reference's restrictor, transposed layout: coarse node k
    takes the mean of the residual over the corner child at that node;
    corners (Cc, 3) holds those children."""
    return r_fine_t[:, corners, :].mean(dim=0).permute(1, 0, 2).contiguous()


def _transfer_tensors(n_coarse: int, like: torch.Tensor):
    """_transfer_tables on like's device: fine_of and parent as int64,
    pweights in like's dtype."""
    fine_of, parent, pweights = _transfer_tables(n_coarse)
    return (torch.as_tensor(fine_of.astype(np.int64), device=like.device),
            torch.as_tensor(parent.astype(np.int64), device=like.device),
            torch.as_tensor(pweights, dtype=like.dtype, device=like.device))


def restrict(r_fine: torch.Tensor, n_coarse: int) -> torch.Tensor:
    """``restrict_t`` in the natural layout: the residual (U, Cf, 3) at
    split depth n_coarse+1 -> (U, Cc, 3) at n_coarse."""
    fine_of, _, pweights = _transfer_tensors(n_coarse, r_fine)
    return from_t(restrict_t(to_t(r_fine), fine_of, pweights))


def restrict_corner_average(r_fine: torch.Tensor,
                            n_coarse: int) -> torch.Tensor:
    """``restrict_corner_average_t`` in the natural layout: (U, Cf, 3) ->
    (U, Cc, 3)."""
    fine_of, _, _ = _transfer_tensors(n_coarse, r_fine)
    return from_t(restrict_corner_average_t(to_t(r_fine), fine_of[:, :3]))


def prolong(e_coarse: torch.Tensor, n_coarse: int) -> torch.Tensor:
    """``prolong_t`` in the natural layout: the coarse correction (U, Cc,
    3) -> (U, Cf, 3)."""
    _, parent, pweights = _transfer_tensors(n_coarse, e_coarse)
    return from_t(prolong_t(to_t(e_coarse), parent, pweights))


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------


def _check_config(cfg: SemiConfig):
    """Raise for settings that name no path or that contradict each
    other."""
    if cfg.coarse_operator not in ("geometric", "galerkin"):
        raise ValueError(f"unknown coarse_operator {cfg.coarse_operator!r}")
    if cfg.restrictor not in ("linear", "corner_average"):
        raise ValueError(f"unknown restrictor {cfg.restrictor!r}")
    if cfg.coarse_krylov:
        # an inner CG makes the V-cycle a nonlinear preconditioner
        if cfg.krylov:
            raise ValueError(
                "coarse_krylov=True cannot be combined with krylov=True:"
                " an inner CG makes the V-cycle preconditioner nonlinear"
                " across outer Krylov iterations")
        if cfg.physics.advection:
            warnings.warn(
                "coarse_krylov assumes an SPD coarse operator; advective"
                " physics may misconverge — prefer stationary coarse"
                " sweeps here", stacklevel=3)


class Stepper(typing.NamedTuple):
    """How a solver steps in time: ``step`` maps a state in its stepping
    layout to the next, ``convergence`` gives the residual norm of such a
    state, ``to_state`` / ``from_state`` convert from / to the standard
    (U, C, 3) layout (only where a state is read or written)."""
    to_state: typing.Callable
    step: typing.Callable
    convergence: typing.Callable
    from_state: typing.Callable


# solvers whose smoothing phases run as whole K1 phases on the stencil path
_PHASE_SOLVERS = (Solver.CHEBYSHEV, Solver.BLOCK_JACOBI)
# the kernels of the geometric cycle's graphs: K1 (its bytes watched) and
# the level transfers
_CYCLE_KERNELS = (("k1", (K1_KERNEL, K1_CHECKED)),
                  ("transfer", (transfer.KERNEL,)))
# the graph of the geometric Krylov preconditioner (``_precond_t``): its
# span holds the input copy, the replay and the output copy
MG_GRAPH = cuda_graph.Kind("pamg.mg.graph", "mg_graph", _CYCLE_KERNELS,
                           copy_out=True)
# the graph of the bare time step's cycles (``_cycles_t``): its span holds
# the two input copies, the replay and the output copy
STEP_GRAPH = cuda_graph.Kind("pamg.step.graph", "step_graph",
                             _CYCLE_KERNELS, copy_out=True)
# identity columns apply_A takes at once when the non-stencil path builds
# its dense coarse matrix
COARSE_COLUMNS = 256


class SemiSolver(nn.Module):
    """Theta-scheme V-cycle / Krylov transport solver on one device.

    Three paths, chosen from the configuration as the JAX package chooses
    them:

    - the stencil path with Chebyshev or block-Jacobi smoothing: every
      smoothing phase is one K1 phase;
    - the stencil path with point Jacobi, Richardson, colored Gauss-Seidel
      or direct (which relaxes as Jacobi): the smoothers of
      ``ops.smoothers`` over the operator, each apply a zero-round K1
      phase (``_smooth_t``);
    - the non-stencil path (``stencil_operator=False``, or 4**n_split above
      ``stencil_max_children``: n_split >= 8 by default): the same cycle over
      ``ops.fused.FusedOperator`` (``fast_operator``) or ``apply_A``, with
      exact block inverses for Chebyshev and block-Jacobi.  It builds no
      SA hierarchy and launches no kernel.

    Args:
      problem: ``build_problem``'s host tables.
      device:  where the state and all operator buffers live; a CUDA device
        runs every stencil-path operator apply and phase through kernel K1
        (float32 or float64, cfg.dtype).
      host:    optional precomputed host parts, as
        ``convert.solver_from_numpy`` passes them: on the stencil path
        {"stencil": [StencilData], "lam_max": [float] or None,
        "coarse_inv": array or None, and optionally "agg":
        ``agg.HostHierarchy`` or None}; on the non-stencil path {"lam_max",
        "coarse_inv" and "block_inv": [(U, C, 3, 3) arrays] or None}.  What
        is not given is built from ``problem``.
    """

    def __init__(self, problem: SemiProblem, device, host: dict | None = None):
        super().__init__()
        with tracing.stage("pamg.setup.solver"):
            self._setup(problem, device, host)

    def _setup(self, problem: SemiProblem, device, host: dict | None):
        """The build of ``__init__``, its stages nested in
        ``pamg.setup.solver``: the stencils, the lam_max estimates, the
        coarse inverse, the SA hierarchy and the device uploads."""
        cfg = problem.cfg
        _check_config(cfg)
        self.p = problem
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        nl = len(problem.levels)
        self.stencil = (cfg.stencil_operator
                        and 4 ** cfg.n_split <= cfg.stencil_max_children)
        self.phase_cycle = self.stencil and cfg.solver in _PHASE_SOLVERS
        self.krylov_iters: list[int] = []
        # the CUDA graphs of the preconditioner, keyed (dtype, device,
        # shape), and of the bare step's cycles, ("step", dtype, device,
        # shape)
        self._graphs: dict = {}
        # the span of each level's V-cycle, named once
        self._level_spans = tuple(f"pamg.vcycle.l{li}" for li in range(nl))
        self.fused = None
        self._levels_t = None
        self._block_inv = None
        self.agg = None
        self._agg_host = None
        self._agg_li = None
        if self.stencil:
            coarse_inv = self._stencil_setup(host)
        else:
            coarse_inv = self._fused_setup(host)
        self._coarse_inv_np = coarse_inv

        with tracing.stage("pamg.setup.upload"):
            self._upload_buffers(coarse_inv)
        self.sanitizer = None
        if cfg.debug:
            self._make_checked("_step_t")

    def _upload_buffers(self, coarse_inv):
        """The device buffers of the cycle and the step: point-relaxation
        diagonals, transfer tables, the dense coarse inverse and the
        finest level's tables."""
        problem, cfg = self.p, self.cfg
        nl = len(problem.levels)

        def buf(name, a):
            self.register_buffer(name, torch.tensor(
                np.ascontiguousarray(np.asarray(a, cfg.dtype)),
                device=self.device))

        # point-relaxation diagonal (3, C, U) and, for colored Gauss-Seidel,
        # the up-children color (1, C, 1) of each level
        if cfg.solver in (Solver.JACOBI, Solver.GAUSS_SEIDEL, Solver.DIRECT):
            for li, L in enumerate(problem.levels):
                Lt = (self._levels_t[li] if self._levels_t is not None
                      else level_tensors(L, "cpu"))
                d = diag_A(Lt, cfg.physics, cfg.dt, cfg.theta)
                self.register_buffer(f"diag_t_{li}",
                                     to_t(d).to(self.device))
                self.register_buffer(f"up_{li}", torch.as_tensor(
                    np.asarray(L["updown"]) > 0,
                    device=self.device)[None, :, None])

        # transfer tables between level li-1 (fine) and li (coarse), their
        # ranges checked once: the transfer kernels read them unchecked
        for li in range(1, nl):
            fine_of, parent, pweights = _transfer_tables(
                problem.levels[li]["s"])
            buf(f"pweights_{li}", pweights)
            for name, idx in (("fine_of", fine_of), ("parent", parent)):
                self.register_buffer(f"{name}_{li}", torch.as_tensor(
                    idx.astype(np.int64), device=self.device))
            transfer.check_tables(
                *(getattr(self, f"{name}_{li}")
                  for name in ("fine_of", "parent", "pweights")),
                int(problem.levels[li - 1]["C"]))

        # dense coarse inverse permuted into transposed flat order
        # (i, c, u), so the in-cycle coarse solve needs no transposes
        self.register_buffer("coarse_inv_t", None)
        if coarse_inv is not None:
            Lc = problem.levels[-1]
            Uc, Cc = Lc["M"].shape[0], Lc["updown"].shape[0]
            u_, c_, i_ = np.meshgrid(np.arange(Uc), np.arange(Cc),
                                     np.arange(3), indexing="ij")
            old_to_new = (i_ * Cc * Uc + c_ * Uc + u_).reshape(-1)
            perm = np.argsort(old_to_new)
            buf("coarse_inv_t", coarse_inv[perm][:, perm])

        self._fine_tables()

    def _make_checked(self, step: str):
        """debug: range-check the index tables, route every K1 and K2 call
        through the kernels' checked builds and make the method ``step`` a
        checked step (``utils.debugging``)."""
        self.sanitizer = debugging.attach(self)
        setattr(self, step, debugging.checked(getattr(self, step),
                                              self.sanitizer))

    def stepper(self) -> Stepper:
        """The transposed (3, C, U) time step: ``_step_t`` (checked under
        debug) and ``convergence_t``."""
        return Stepper(to_t, self._step_t, self.convergence_t, from_t)

    def _stencil_setup(self, host):
        """The stencil path's operators (``ops``), spectral bounds and SA
        hierarchy; returns the dense coarse inverse or None."""
        problem, cfg = self.p, self.cfg
        nl = len(problem.levels)
        if host is None:
            build = probe_stencil if cfg.stencil_probe else build_stencil
            with tracing.stage("pamg.setup.stencils"):
                datas = [build(L, cfg.physics, cfg.dt, cfg.theta)
                         for L in problem.levels]
                if cfg.coarse_operator == "galerkin":
                    # variational P^T A P coarse blocks instead of the
                    # per-level geometric assembly
                    for i in range(1, nl):
                        datas[i] = galerkin.galerkin_coarse(
                            datas[i - 1], problem.levels[i]["s"], datas[i])
            with tracing.stage("pamg.setup.lam_max"):
                lam_max = ([lam_max_estimate(d) for d in datas]
                           if cfg.solver == Solver.CHEBYSHEV else None)
            coarse_inv = self._build_coarse_inverse(datas)
        else:
            datas, lam_max = host["stencil"], host["lam_max"]
            coarse_inv = host["coarse_inv"]
        self._lam_max = lam_max
        with tracing.stage("pamg.setup.upload"):
            self.ops = nn.ModuleList(
                StencilOperator(d, self.dtype, self.device) for d in datas)

        # SA hierarchy: in amg mode it corrects the finest level (the
        # geometric levels are bypassed); otherwise it continues below a
        # geometric coarsest that the dense inverse does not take
        li = None
        if cfg.amg:
            li = 0
        elif (cfg.coarse_agg and not cfg.coarse_krylov and coarse_inv is None
                and nl > 1):
            li = nl - 1
        if li is not None:
            if host is not None and "agg" in host:
                h = host["agg"]
            else:
                coords = splitting.child_coords(problem.grid.macro.X,
                                                problem.levels[li]["s"])
                with tracing.stage("pamg.setup.sa_hierarchy"):
                    h = agg.build_hierarchy(
                        datas[li], coords,
                        max_dense_dof=cfg.agg_dense_max_dof,
                        omega=cfg.omega, sweeps=cfg.agg_sweeps,
                        dtype=np.dtype(cfg.dtype),
                        strength=cfg.agg_strength, always=cfg.amg,
                        drop_tol=cfg.agg_drop_tol, target=cfg.agg_target)
            if h.levels:
                with tracing.stage("pamg.setup.upload"):
                    self.agg = agg.AggHierarchy(h, self.dtype, self.device)
                # the host tables, which the distributed solver shards
                self._agg_host = h
                self._agg_li = li
                if self.agg.fine_dinv_t is not None:
                    # (3, E) -> (3, C, U), E = u*C + c
                    op = self.ops[li]
                    self.register_buffer(
                        "agg_fine_dinv_t", self.agg.fine_dinv_t.reshape(
                            3, op.U, op.C).transpose(1, 2).contiguous())
        return coarse_inv

    def _fused_setup(self, host):
        """The non-stencil path: the level tables on the device, the
        transposed-layout operators (``fused``, with ``fast_operator``), the
        exact block inverses and spectral bounds of Chebyshev and
        block-Jacobi; returns the dense coarse inverse or None."""
        problem, cfg = self.p, self.cfg
        phys = cfg.physics
        self.ops = nn.ModuleList()
        with tracing.stage("pamg.setup.upload"):
            self._levels_t = [level_tensors(L, self.device)
                              for L in problem.levels]
            if cfg.fast_operator:
                self.fused = nn.ModuleList(
                    FusedOperator(L, phys, cfg.dt, cfg.theta, self.device)
                    for L in problem.levels)
        if cfg.solver in _PHASE_SOLVERS:
            if host is not None and host.get("block_inv") is not None:
                self._block_inv = [
                    torch.tensor(np.asarray(B), device=self.device)
                    for B in host["block_inv"]]
            else:
                self._block_inv = [
                    torch.linalg.inv(diag_blocks_A(Lt, phys, cfg.dt,
                                                   cfg.theta))
                    for Lt in self._levels_t]
            for li, B in enumerate(self._block_inv):
                self.register_buffer(f"binv_t_{li}",
                                     B.permute(2, 3, 1, 0).contiguous())
        if host is not None and host.get("lam_max") is not None:
            self._lam_max = list(host["lam_max"])
        else:
            with tracing.stage("pamg.setup.lam_max"):
                self._lam_max = ([self._estimate_lam_max(li)
                                  for li in range(len(problem.levels))]
                                 if cfg.solver == Solver.CHEBYSHEV else None)
        if host is not None:
            return host["coarse_inv"]
        return self._build_coarse_inverse(None)

    def _fine_tables(self):
        """The finest level's buffers of the right-hand side and the error:
        M_t (3, 3, U), source_t (3, C, U), analytical (U, C, 3), and for a
        theta < 1 step the level's tables of its explicit part."""
        cfg, L0 = self.cfg, self.p.levels[0]
        for name, a in (("M_t", L0["M"].transpose(1, 2, 0)),
                        ("source_t", L0["source"].transpose(2, 1, 0)),
                        ("analytical", self.p.analytical)):
            self.register_buffer(name, torch.tensor(
                np.ascontiguousarray(np.asarray(a, cfg.dtype)),
                device=self.device))
        self._L0 = None
        if cfg.theta < 1.0:
            self._L0 = (self._levels_t[0] if self._levels_t is not None
                        else level_tensors(L0, self.device))

    def _build_coarse_inverse(self, datas):
        """Dense inverse of the coarsest level (host numpy, the run dtype)
        when it has at most coarse_direct_max_dof DOF, else None: of the
        block stencil's matrix on the stencil path, else of apply_A's,
        which it applies to the identity in batches of columns.  The set-up
        stage ``pamg.setup.coarse_inverse``."""
        with tracing.stage("pamg.setup.coarse_inverse"):
            if len(self.p.levels) == 1:
                return None
            cfg = self.cfg
            L = self.p.levels[-1]
            U, C = L["M"].shape[0], L["updown"].shape[0]
            N = U * C * 3
            if N > cfg.coarse_direct_max_dof:
                return None
            if datas is not None:
                return np.linalg.inv(to_dense(datas[-1])).astype(
                    L["M"].dtype)
            Lt = level_tensors(L, "cpu")
            eye = torch.eye(N, dtype=self.dtype).reshape(N, U, C, 3)
            cols = torch.func.vmap(
                lambda v: apply_A(Lt, cfg.physics, cfg.dt, cfg.theta, v,
                                  False),
                chunk_size=COARSE_COLUMNS)(eye)
            return torch.linalg.inv(cols.reshape(N, N).T).numpy()

    def _estimate_lam_max(self, li: int) -> float:
        """Power iteration on D^-1 A (homogeneous, D the exact diagonal
        blocks) from the seeded normal vector of the JAX package: 30
        normalized applies and a last one, with a 1.2 safety factor."""
        cfg = self.cfg
        Lt = self._levels_t[li]
        U, C = Lt["M"].shape[0], Lt["updown"].shape[0]
        Ainv = self._block_inv[li]
        v = torch.as_tensor(np.random.default_rng(li).normal(size=(U, C, 3)),
                            dtype=self.dtype, device=self.device)

        def it(v):
            return torch.einsum("ucij,ucj->uci", Ainv, apply_A(
                Lt, cfg.physics, cfg.dt, cfg.theta, v, False))

        for _ in range(30):
            w = it(v)
            v = w / torch.linalg.vector_norm(w)
        # Chebyshev amplifies any eigenvalue beyond the interval: an
        # overestimate is cheap, an underestimate fatal
        return 1.2 * float(torch.linalg.vector_norm(it(v)))

    # -- schedules -----------------------------------------------------------
    def _coarse_cheb_override(self, li: int) -> bool:
        return (self.cfg.coarse_cheb_degree is not None
                and len(self.p.levels) > 1
                and li == len(self.p.levels) - 1)

    def _cheb_roots(self, li: int):
        cfg = self.cfg
        deg, lower = cfg.cheb_degree, cfg.cheb_lower
        if self._coarse_cheb_override(li):
            deg = cfg.coarse_cheb_degree
            if cfg.coarse_cheb_lower is not None:
                lower = cfg.coarse_cheb_lower
        return smoothers.chebyshev_roots(self._lam_max[li], deg, lower)

    def _cheb_reps(self, li: int, sweeps: int, n_roots: int) -> int:
        """Polynomial repetitions: with a coarse-degree override the
        polynomial IS the coarse solve — exactly one rep."""
        if self._coarse_cheb_override(li):
            return 1
        return max(1, sweeps // n_roots)

    def _phase_coefs(self, li: int, sweeps: int):
        """Per-round step sizes of one relaxation phase."""
        cfg = self.cfg
        if cfg.solver == Solver.CHEBYSHEV:
            roots = self._cheb_roots(li)
            reps = self._cheb_reps(li, sweeps, len(roots))
            return [1.0 / r for r in roots] * reps
        return [cfg.omega] * sweeps

    # -- operator ------------------------------------------------------------
    def _apply_t(self, li: int, x_t, with_bc: bool = False):
        """A x in transposed layout.  On the stencil path a zero-round
        phase: z = -D^-1 A x, so A x = -D z (one K1 launch on the card);
        otherwise the fused operator or apply_A."""
        if self.stencil:
            op = self.ops[li]
            _, z_t = phase(op, x_t, torch.zeros_like(x_t), [])
            ax = -op.mul_self(z_t)
            return ax + op.c_aff_t if with_bc else ax
        if self.fused is not None:
            return self.fused[li].apply(x_t, with_bc)
        cfg = self.cfg
        return to_t(apply_A(self._levels_t[li], cfg.physics, cfg.dt,
                            cfg.theta, from_t(x_t), with_bc))

    def residual(self, li: int, x, b, with_bc: bool):
        """b - A x in the standard (U, C, 3) layout."""
        return from_t(to_t(b) - self._apply_t(li, to_t(x), with_bc))

    def _restrict_t(self, r_t, li_coarse: int, S_t=None):
        """The coarse right-hand side of level li_coarse from the residual
        S_t r_t of the level above (r_t itself without S_t): P^T by
        ``ops.transfer.restrict`` (one kernel launch on the card), or the
        reference's corner average."""
        if self.cfg.restrictor == "corner_average":
            return restrict_corner_average_t(
                mul_blocks(S_t, r_t),
                getattr(self, f"fine_of_{li_coarse}")[:, :3])
        return transfer.restrict(r_t, getattr(self, f"fine_of_{li_coarse}"),
                                 getattr(self, f"pweights_{li_coarse}"), S_t)

    def _prolong_add_t(self, x_t, e_t, li_coarse: int):
        """x_t + P e_t, the coarse correction e_t of level li_coarse added
        to the level above (``ops.transfer.prolong_add``: one kernel launch
        on the card)."""
        return transfer.prolong_add(x_t, e_t,
                                    getattr(self, f"parent_{li_coarse}"),
                                    getattr(self, f"pweights_{li_coarse}"))

    def _solve_blocks_t(self, li: int):
        """r -> B^-1 r with the exact diagonal-block inverses of level li
        (non-stencil path), transposed layout, or None without them."""
        if self._block_inv is None:
            return None
        B = getattr(self, f"binv_t_{li}")                # (3, 3, C, U)
        return lambda r: torch.stack([
            B[i, 0] * r[0] + B[i, 1] * r[1] + B[i, 2] * r[2]
            for i in range(3)])

    def _coarse_cg_t(self, li: int, x_t, b_t):
        """Coarsest-level solve by `coarse_sweeps` PCG iterations
        (coarse_krylov=True), preconditioned by the diagonal blocks: the
        stencil's on the phase path, the exact inverses on the non-stencil
        path with Chebyshev or block-Jacobi, none otherwise (as in the JAX
        package)."""
        if self.phase_cycle:
            precond = self.ops[li].solve_diag
        else:
            precond = self._solve_blocks_t(li) or (lambda r: r)
        x_sol, _, _ = krylov.pcg(
            lambda v: self._apply_t(li, v, False), b_t, x_t,
            precond=precond, tol=0.0, maxiter=self.cfg.coarse_sweeps)
        return x_sol

    def _agg_correct_t(self, li: int, x_t, r_t):
        """SA correction of level li from its residual r_t (3, C, U):
        restrict into the SA hierarchy, V-cycle there, prolong back.

        On the phase path, with the factored fine transfers P = (I - w D^-1
        A) P_tent and a symmetric operator (no advection), P^T r = P_tent^T
        (r - w A D^-1 r) and P e = (I - w D^-1 A) P_tent e: the smoothing
        factor runs as one zero-round K1 apply on each side.  Otherwise the
        stored smoothed transfers run, as the JAX package's standard-layout
        cycle runs them."""
        h = self.agg
        cfg = self.cfg
        C, U = r_t.shape[1], r_t.shape[2]

        def to_flat(v):                                   # e = u*C + c
            return v.transpose(1, 2).reshape(3, U * C)

        def from_flat(v):
            return v.reshape(3, U, C).transpose(1, 2).contiguous()

        with tracing.span("pamg.sa"):
            if (self.phase_cycle and h.tent_r is not None
                    and not cfg.physics.advection):
                w = h.w
                dinv = self.agg_fine_dinv_t
                y_t = r_t - w * self._apply_t(li, dinv * r_t)
                rc = h.tent_r(to_flat(y_t))
                e = agg.vcycle_iter(h, rc, cfg.agg_cycles)
                ef = from_flat(h.tent_p(e))
                return x_t + (ef - w * (dinv * self._apply_t(li, ef)))
            return x_t + from_flat(agg.correct_t(h, to_flat(r_t),
                                                 cfg.agg_cycles))

    def _coarse_direct_t(self, x_t, b_t):
        return (self.coarse_inv_t @ b_t.reshape(-1)).reshape(x_t.shape)

    # -- V-cycle -------------------------------------------------------------
    def _smoother_t(self, li: int, b_t, with_bc: bool):
        """Level li's smoothing step for right-hand side b_t, as
        ``smooth(x_t, sweeps, want_r) -> (x_t, r_t, S_t)``: when want_r
        the residual b - A x at the new x is ``mul_blocks(S_t, r_t)``, else
        r_t is None.  On the phase cycle one K1 phase over the
        premultiplied b, whose z = D^-1 (b - A x) is r_t and the self
        blocks D (``ops[li].S_t``) S_t; otherwise ``_smooth_t`` followed
        by b - A x as r_t, S_t None."""
        if self.phase_cycle:
            op = self.ops[li]
            bp = op._bp(b_t, with_bc)

            def smooth(x_t, sweeps, want_r):
                return (*phase(op, x_t, bp, self._phase_coefs(li, sweeps),
                               want_z=want_r), op.S_t)
            return smooth

        def smooth(x_t, sweeps, want_r):
            x_t = self._smooth_t(li, x_t, b_t, sweeps, with_bc)
            return x_t, (b_t - self._apply_t(li, x_t, with_bc) if want_r
                         else None), None
        return smooth

    def _vcycle_t(self, li: int, x_t, b_t, hom: bool = False):
        """Level-li V-cycle in the transposed layout: smooth, residual and
        restriction (``_restrict_t``, which forms the residual from the
        phase's z on the phase cycle), coarse cycle, prolongation with the
        add (``_prolong_add_t``), smooth; at the SA level smooth,
        residual, SA correction, smooth (the fine level in amg mode, else
        the geometric coarsest); the coarsest geometric level solves by the
        dense inverse, coarse CG or sweeps.  This is the JAX package's
        standard-layout ``_vcycle`` and, with K1 phases as the smoother, its
        transposed-layout cycle.  hom=True solves the homogeneous-BC
        (linear) problem, as a Krylov preconditioner does.  The span
        ``pamg.vcycle.l<li>``, and ``pamg.coarse`` around a coarse direct
        or CG solve."""
        cfg = self.cfg
        nl = len(self.p.levels)
        with_bc = li == 0 and not hom
        sa_level = self.agg is not None and li == self._agg_li
        coarsest = li == nl - 1 and not sa_level
        with tracing.span(self._level_spans[li]):
            if coarsest and nl > 1 and self.coarse_inv_t is not None:
                with tracing.span("pamg.coarse"):
                    return self._coarse_direct_t(x_t, b_t)
            if coarsest and nl > 1 and cfg.coarse_krylov:
                with tracing.span("pamg.coarse"):
                    return self._coarse_cg_t(li, x_t, b_t)
            smooth = self._smoother_t(li, b_t, with_bc)
            if coarsest:
                sweeps = cfg.coarse_sweeps if nl > 1 else cfg.n_smooth
                return smooth(x_t, sweeps, False)[0]
            # the residual is mul_blocks(S_t, r_t) (``_smoother_t``)
            x_t, r_t, S_t = smooth(x_t, cfg.n_smooth, True)
            if sa_level:
                x_t = self._agg_correct_t(li, x_t, mul_blocks(S_t, r_t))
            else:
                bc_ = self._restrict_t(r_t, li + 1, S_t)
                e_t = self._vcycle_t(li + 1, torch.zeros_like(bc_), bc_, hom)
                if cfg.cycle_type == "w" and li < 2:
                    # W only near the top: the coarse systems below are
                    # solved accurately enough by one visit
                    e_t = self._vcycle_t(li + 1, e_t, bc_, hom)
                x_t = self._prolong_add_t(x_t, e_t, li + 1)
            return smooth(x_t, cfg.n_smooth, False)[0]

    def _smooth_t(self, li: int, x_t, b_t, sweeps: int, with_bc: bool):
        """``sweeps`` sweeps of the configured smoother over ``_apply_t``
        (every path but the phase cycle): Chebyshev and block-Jacobi with
        the exact block inverses, Richardson, two-color Gauss-Seidel with
        surface terms (the colors are the up children and the rest; without
        surface terms no element couples to another and it is Jacobi), and
        Jacobi, which ``direct`` also relaxes with."""
        cfg = self.cfg
        A = lambda v: self._apply_t(li, v, with_bc)
        if cfg.solver == Solver.CHEBYSHEV:
            roots = self._cheb_roots(li)
            return smoothers.chebyshev(
                A, b_t, x_t, self._solve_blocks_t(li), roots,
                self._cheb_reps(li, sweeps, len(roots)))
        if cfg.solver == Solver.RICHARDSON:
            return smoothers.richardson(A, b_t, x_t, cfg.omega, sweeps)
        if cfg.solver == Solver.BLOCK_JACOBI:
            return smoothers.block_jacobi_solve(
                A, b_t, x_t, self._solve_blocks_t(li), cfg.omega, sweeps)
        d = getattr(self, f"diag_t_{li}")
        if cfg.solver == Solver.GAUSS_SEIDEL and cfg.physics.surface_terms:
            up = getattr(self, f"up_{li}")
            return smoothers.colored_gs(A, b_t, x_t, d, (up, ~up),
                                        cfg.omega, sweeps)
        return smoothers.jacobi(A, b_t, x_t, d, cfg.omega, sweeps)

    # -- time stepping -------------------------------------------------------
    def _rhs_t(self, told_t):
        """b = M told/dt + M s - (1 - theta) L(told) (Dirichlet ghosts in
        L) in transposed layout; the span ``pamg.rhs``."""
        cfg = self.cfg

        def mul_M(v_t):
            return (self.M_t[:, :, None, :] * v_t[None]).sum(dim=1)
        with tracing.span("pamg.rhs"):
            b_t = mul_M(told_t) / cfg.dt + mul_M(self.source_t)
            if cfg.theta < 1.0:
                spat = apply_spatial(self._L0, cfg.physics, from_t(told_t),
                                     True)
                b_t = b_t - (1.0 - cfg.theta) * to_t(spat)
            return b_t

    def solve_system(self, b, x0):
        """``_solve_system_t`` in the natural layout: A x = b (Dirichlet
        ghosts folded in) from x0, both (U, C, 3); PCG, or BiCGStab under
        advection, its iteration count appended to ``krylov_iters``."""
        return from_t(self._solve_system_t(to_t(b), to_t(x0)))

    def _solve_system_t(self, b_t, x0_t):
        """A x = b (Dirichlet ghosts folded in) by PCG, or BiCGStab under
        advection (a nonsymmetric operator), preconditioned by one cycle
        (``_precond_t``); the iteration count is appended to
        ``krylov_iters``."""
        cfg = self.cfg
        A_lin = lambda x_t: self._apply_t(0, x_t, False)
        c = self._apply_t(0, torch.zeros_like(b_t), True)   # = c_aff
        b_lin = b_t - c
        precond = self._precond_t
        method = krylov.bicgstab if cfg.physics.advection else krylov.pcg
        x_t, it, _ = method(A_lin, b_lin, x0_t, precond=precond,
                            tol=cfg.krylov_tol, maxiter=cfg.krylov_maxiter)
        self.krylov_iters.append(it)
        return x_t

    def _graphable(self, t) -> bool:
        """Whether cycles on t replay as a CUDA graph: t on the card,
        geometric levels only (no SA level), K1 phases as the smoother and
        no coarse CG (whose stop rule reads the card on the host)."""
        return (t.device.type == "cuda" and self.phase_cycle
                and self.agg is None and not self.cfg.coarse_krylov)

    def _replay(self, kind: cuda_graph.Kind, key: tuple, fn, ts: tuple):
        """fn(*ts) as one replay of the solver's CUDA graph of ``kind``
        under ``key`` (in ``_graphs``; ``cuda_graph.cached``), captured at
        the first such call, whose result is the eager call's, and
        captured again, in its place, when the levels' sanitizer sites
        have changed; the least bytes of its K1 calls as ``ops.phase.watch``
        reckons them."""
        sites = tuple(op.sanitizer for op in self.ops)
        return cuda_graph.cached(
            self._graphs, key, sites,
            lambda: cuda_graph.capture(kind, fn, ts, sites, watch_k1()), ts)

    def _precond_t(self, r_t):
        """The Krylov preconditioner: one homogeneous cycle from zero on
        r_t, ``_vcycle_t(0, 0, r_t, hom=True)``.

        Where ``_graphable(r_t)``, the cycle is one replay of the graph
        for r_t's dtype, device and shape (``MG_GRAPH``, ``_replay``).  A
        replay returns a copy of the graph's output, since PCG keeps z as
        its search direction across the next call (BiCGStab keeps two
        preconditioned vectors).  Otherwise the cycle runs eagerly."""
        def cycle(r):
            return self._vcycle_t(0, torch.zeros_like(r), r, hom=True)

        if not self._graphable(r_t):
            return cycle(r_t)
        return self._replay(MG_GRAPH,
                            (r_t.dtype, r_t.device, tuple(r_t.shape)),
                            cycle, (r_t,))

    def _cycles_t(self, T_t, b_t):
        """The bare step's ``n_multigrid`` cycles ``_vcycle_t(0, T, b)``
        from T_t on b_t.

        Where ``_graphable(T_t)``, they are one replay of the graph for
        T_t's dtype, device and shape (``STEP_GRAPH``, key ("step", dtype,
        device, shape), ``_replay``), which reads copies of T_t and b_t
        and returns a copy of its output, since the caller keeps the state
        across the next step.  Otherwise they run eagerly."""
        def cycles(x_t, b):
            for _ in range(self.cfg.n_multigrid):
                x_t = self._vcycle_t(0, x_t, b)
            return x_t

        if not self._graphable(T_t):
            return cycles(T_t, b_t)
        return self._replay(STEP_GRAPH,
                            ("step", T_t.dtype, T_t.device, tuple(T_t.shape)),
                            cycles, (T_t, b_t))

    def _step_t(self, T_t):
        """One theta-scheme time step of the transposed state: the right-
        hand side, then the Krylov solve or the bare cycles
        (``_cycles_t``); the span ``pamg.step``, counted in ``steps``."""
        tracing.count("steps")
        with tracing.span("pamg.step"):
            b_t = self._rhs_t(T_t)
            if self.cfg.krylov:
                return self._solve_system_t(b_t, T_t)
            return self._cycles_t(T_t, b_t)

    def initial_condition(self) -> torch.Tensor:
        """ic callable if configured, else region_id == 4 painted to 1;
        (U, C, 3) on the solver's device."""
        np_dtype = np.dtype(self.cfg.dtype)
        if self.cfg.fns.ic is not None:
            cf = self.p.coords_fine
            T = np.broadcast_to(
                np.asarray(self.cfg.fns.ic(cf[:, :, 0], cf[:, :, 1]),
                           np.float64), cf[:, :, 0].shape).astype(np_dtype)
        else:
            U = self.p.grid.macro.num_elements
            T = np.zeros((U, self.p.levels[0]["C"], 3), np_dtype)
            T[self.p.grid.macro.region_id == 4] = 1.0
        return torch.as_tensor(T, device=self.device)

    def run(self, T=None, ntime: int | None = None):
        """ntime steps from T (default: the initial condition); the state
        stays transposed between steps."""
        if T is None:
            T = self.initial_condition()
        T_t = to_t(T)
        for _ in range(ntime or self.cfg.ntime):
            T_t = self._step_t(T_t)
        return from_t(T_t)

    def error(self, T) -> torch.Tensor:
        """|T - analytical|."""
        return (T - self.analytical).abs()

    def convergence(self, T) -> torch.Tensor:
        """L-inf norm of the residual of the state T (U, C, 3)."""
        return self.convergence_t(to_t(T))

    def convergence_t(self, T_t) -> torch.Tensor:
        """L-inf norm of the residual b(T) - A T, transposed layout; the
        span ``pamg.residual``."""
        with tracing.span("pamg.residual"):
            r_t = self._rhs_t(T_t) - self._apply_t(0, T_t, True)
            return r_t.abs().max()


def solve(mesh: MacroMesh, cfg: SemiConfig | None, device):
    """Build, then run cfg.ntime steps from the initial condition."""
    cfg = cfg or SemiConfig()
    solver = SemiSolver(build_problem(mesh, cfg), device)
    return solver, solver.run()

"""Assembled-operator variant of the semi-structured solver (modes 10 and
8), port of the JAX package's ``models/semi_assembled.py``.

The DG operator of the finest level is assembled once, on the host at the
run dtype, into the fixed-degree BSR layout of ``ops.bsr``: one diagonal
block plus one block per face, E = U*C block rows e = u*C + c.

- Mode 10 (``AssembledSemiSolver``): each time step runs
  ``n_multigrid * n_smooth`` damped block-Jacobi sweeps
  x <- x + omega D^-1 (b - c - A x) on the assembled system; the residual's
  product A x is one launch of kernel K2 (``ops.spmv``) on a CUDA tensor,
  the 3x3 block solve and the update are torch ops, and the state stays in
  the transposed (3, E) layout across the sweeps of a step.
- Mode 8 (``direct_solve``): the same matrix densified on the device,
  inverted once (``torch.linalg.inv``, the counterpart of the JAX package's
  host ``np.linalg.inv``) and applied by one matrix-vector product a step.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from ..config import Physics, SemiConfig
from ..mesh import splitting
from ..ops import bsr
from ..ops.fused import from_t, to_t
from ..ops.stencil import StencilOperator, build_stencil
from . import semi


def _face_blocks(L: dict, phys: Physics, theta: float) -> torch.Tensor:
    """Off-diagonal (neighbor-coupling) blocks -> (U, C, 3, nloc, nloc),
    rows in my local node numbering, columns in the neighbor's: the terms of
    ``semi.apply_spatial`` that read the neighbor trace t2.  ``L`` holds a
    level's tables (``semi.level_tensors``)."""
    ein = torch.einsum
    U, C = L["M"].shape[0], L["updown"].shape[0]
    dtype = L["M"].dtype
    B = torch.zeros((U, C, 3, 3, 3), dtype=dtype, device=L["M"].device)
    if not phys.surface_terms:
        return B
    _, snorm, nxc = semi._child_geometry(L)
    sdet = L["sdet"][:, None].expand(U, C, 3, L["sn"].shape[0])
    # my face node k sits at the neighbor's node neigh_perm[..., k]: a term
    # X[..., i, k] of the trace t2_k moves to column neigh_perm[..., k] (the
    # JAX package's one-hot product, as an index)
    idx = L["neigh_perm"][:, :, :, None, :].expand(U, C, 3, 3, 2)

    def to_cols(X):
        return torch.zeros_like(B).scatter_add_(-1, idx, X)

    if phys.diffusion:
        k = phys.k
        dif = L["diff_on"]
        # penalty: -eta k/dx * S2 in the neighbor's columns
        S2 = ein("fgi,gk,ucfg->ucfik", L["face_sn"], L["sn"], sdet)
        pen = -(phys.penalty_factor * k
                * to_cols(ein("ucf,ucfik->ucfik", L["inv_dx"] * dif, S2)))
        B = B + theta * pen
        if phys.sip_consistency:
            # the neighbor's gradient coefficients, gathered across faces
            nxc2 = semi.flat_gather(L, nxc.reshape(U, C, 6)).reshape(
                U, C, 3, 2, 3)
            # consistency (neighbor-gradient half)
            nn2 = ein("ucfgd,ucfdj->ucfgj", snorm, nxc2)
            cons = -0.5 * k * ein("fgi,ucfg,ucfgj->ucfij", L["face_sn"],
                                  sdet * dif[..., None], nn2)
            B = B + theta * cons
            # symmetry (t2 half): +w k (nxc . n)_i sum_g sn_k sdet
            nxn = ein("ucdi,ucfgd->ucfgi", nxc, snorm)
            sym = k * to_cols(ein("ucf,ucfgi,gk,ucfg->ucfik", 0.5 * dif,
                                  nxn, L["sn"], sdet))
            B = B + theta * sym
    if phys.advection:
        un = ein("ucfgd,d->ucfg", snorm,
                 torch.as_tensor(phys.u, dtype=dtype, device=B.device))
        income = 0.5 + 0.5 * torch.sign(-un)
        adv = to_cols(ein("fgi,ucfg,gk->ucfik", L["face_sn"],
                          un * sdet * income, L["sn"]))
        B = B + theta * adv
    return B


def _neumann_mirror(L: dict, phys: Physics, theta: float) -> torch.Tensor:
    """(U, C, 3, 3) self coupling of the advective income flux on no-flux
    faces, where the neighbor trace is my own (``neighbor_trace``):
    ``apply_spatial`` has it and so does the block stencil
    (``ops.stencil.build_stencil``); ``diag_blocks_A`` does not."""
    U, C = L["M"].shape[0], L["updown"].shape[0]
    A = torch.zeros((U, C, 3, 3), dtype=L["M"].dtype, device=L["M"].device)
    if not (phys.surface_terms and phys.advection and L["neu_mask"].any()):
        return A
    _, snorm, _ = semi._child_geometry(L)
    un = torch.einsum("ucfgd,d->ucfg", snorm,
                      torch.as_tensor(phys.u, dtype=A.dtype,
                                      device=A.device))
    income = 0.5 + 0.5 * torch.sign(-un)
    sdet = L["sdet"][:, None].expand(un.shape)
    mir = torch.einsum("fgi,ucfg,gk->ucfik", L["face_sn"],
                       un * sdet * income * L["neu_mask"][..., None],
                       L["sn"])
    for f in range(3):
        for kk in range(2):
            A[:, :, :, splitting.CHILD_FACE_NODES[f, kk]] += (
                theta * mir[:, :, f, :, kk])
    return A


def assemble_operator(L: dict, phys: Physics, dt: float,
                      theta: float) -> bsr.BSR:
    """A as a fixed-degree BSR matrix over the flat child elements
    e = u*C + c, assembled on the host from ``build_problem``'s tables of
    one level (numpy, run dtype)."""
    Lt = semi.level_tensors(L, "cpu")
    diag = (semi.diag_blocks_A(Lt, phys, dt, theta)
            + _neumann_mirror(Lt, phys, theta))
    face = _face_blocks(Lt, phys, theta)
    U, C = diag.shape[:2]
    return bsr.build(diag.reshape(U * C, 3, 3).numpy(),
                     face.reshape(U * C, 3, 3, 3).numpy(),
                     np.asarray(L["neigh_elem"]).reshape(U * C, 3))


def affine_offset(L: dict, phys: Physics, dt: float,
                  theta: float) -> np.ndarray:
    """c (U, C, 3) with A_affine(x) = A_bsr x + c: the Dirichlet-ghost load
    of ``apply_A`` at x = 0, on the host."""
    Lt = semi.level_tensors(L, "cpu")
    z = torch.zeros_like(Lt["bc_dense"][..., 0])
    return semi.apply_A(Lt, phys, dt, theta, z, True).numpy()


class AssembledSemiSolver(semi.SemiSolver):
    """Mode 10: a SemiSolver whose time step iterates on the assembled BSR
    operator.

    The slim setup builds the level-0 stencil only (its inverse self
    blocks are the sweeps' D^-1, and ``convergence`` applies it through
    kernel K1's zero-round phase), no coarse levels, SA hierarchy, dense
    inverse or spectral bounds.

    Args:
      problem: ``semi.build_problem``'s host tables (level 0 is used).
      device:  where the state, the operator and all buffers live; a CUDA
        device runs each sweep's product through kernel K2 (float32 or
        float64, cfg.dtype).
      host:    optional precomputed host parts {"stencil0": StencilData,
        "A_bsr": bsr.BSR, "offset": (U, C, 3) array}, as
        ``convert.assembled_from_numpy`` passes them; what is not given is
        built from ``problem``.
    """

    def __init__(self, problem: semi.SemiProblem, device,
                 host: dict | None = None):
        # the slim setup reads no smoother, Krylov or coarse-level field,
        # so no configuration check either
        nn.Module.__init__(self)
        cfg = problem.cfg
        host = host or {}
        self.p, self.cfg = problem, cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.krylov_iters: list[int] = []
        # the residual's operator apply is level 0's stencil through K1
        self.stencil, self.phase_cycle, self._levels_t = True, False, None
        L0 = problem.levels[0]
        args = (L0, cfg.physics, cfg.dt, cfg.theta)
        data0 = host.get("stencil0")
        if data0 is None:
            data0 = build_stencil(*args)
        self.ops = nn.ModuleList([StencilOperator(data0, self.dtype,
                                                  self.device)])
        A_bsr = host.get("A_bsr")
        if A_bsr is None:
            A_bsr = assemble_operator(*args)
        self.A = A_bsr.rowop(self.dtype, self.device)
        offset = host.get("offset")
        if offset is None:
            offset = affine_offset(*args)
        op = self.ops[0]
        E = op.U * op.C
        self.register_buffer("offset", torch.tensor(
            np.ascontiguousarray(np.asarray(offset, cfg.dtype)),
            device=self.device))                              # (U, C, 3)
        # the stencil's inverse self blocks ARE the inverse diagonal blocks
        # of the assembled operator, here (3i, 3j, E) with e = u*C + c
        self.register_buffer("dinv_e", op.Dinv_t.transpose(2, 3).reshape(
            3, 3, E).contiguous())
        self._fine_tables()
        self.sanitizer = None
        if cfg.debug:
            self._make_checked("_step")

    def stepper(self) -> semi.Stepper:
        """The step in the standard (U, C, 3) layout: ``_step`` (checked
        under debug) and ``convergence``."""
        same = lambda T: T
        return semi.Stepper(same, self._step, self.convergence, same)

    @staticmethod
    def _flat(T):
        """(U, C, 3) -> the transposed (3, E) layout of the BSR rows."""
        return T.reshape(-1, 3).T.contiguous()

    def apply_assembled(self, T, with_bc: bool = True):
        """A_bsr T (+ the affine offset), (U, C, 3) -> (U, C, 3)."""
        y = self.A(self._flat(T)).T.reshape(T.shape)
        return y + self.offset if with_bc else y

    def sweeps(self) -> int:
        """Block-Jacobi sweeps (K2 launches) a step."""
        return max(1, self.cfg.n_multigrid * self.cfg.n_smooth)

    def _step(self, T):
        """One theta-scheme step: ``sweeps()`` damped block-Jacobi sweeps on
        A x = b - c from x = T, in the (3, E) layout."""
        b = self._flat(from_t(self._rhs_t(to_t(T))) - self.offset)
        x = self._flat(T)
        for _ in range(self.sweeps()):
            r = b - self.A(x)
            x = x + self.cfg.omega * (self.dinv_e * r[None]).sum(dim=1)
        return x.T.reshape(T.shape)

    def run(self, T=None, ntime: int | None = None):
        """ntime steps from T (default: the initial condition)."""
        if T is None:
            T = self.initial_condition()
        for _ in range(ntime or self.cfg.ntime):
            T = self._step(T)
        return T


def direct_inverse(solver: AssembledSemiSolver) -> torch.Tensor:
    """The inverse of the assembled operator on the solver's device, in the
    run dtype, as the JAX package inverts in the run dtype: densified there
    by index (3E x 3E, 5.9 GB in float32 and 11.8 GB in float64 at the CLI
    defaults' 38,400 DOF) and freed once inverted."""
    A = bsr.to_dense(solver.A)
    Ainv = torch.linalg.inv(A)
    del A
    return Ainv


def direct_step(solver: AssembledSemiSolver, T):
    """One mode-8 step with the solver's inverse ``Ainv``: x = A^-1 (b - c),
    one matrix-vector product."""
    b = from_t(solver._rhs_t(to_t(T))) - solver.offset
    return (solver.Ainv @ b.reshape(-1)).reshape(T.shape)


def direct_solve(mesh, cfg: SemiConfig | None, device):
    """Mode 8: assemble, densify and invert once, then step ``cfg.ntime``
    times with the inverse.  Returns (solver, T); the solver carries its
    inverse ``Ainv`` and ``inverse_seconds``, the host time of the
    inversion (synchronized)."""
    cfg = cfg or SemiConfig()
    solver = AssembledSemiSolver(semi.build_problem(mesh, cfg), device)
    t0 = time.perf_counter()
    solver.Ainv = direct_inverse(solver)
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)
    solver.inverse_seconds = time.perf_counter() - t0
    T = solver.initial_condition()
    for _ in range(cfg.ntime):
        T = direct_step(solver, T)
    return solver, T

"""Distributed stencil V-cycle: the fast multi-rank path (port of the JAX
package's ``parallel/stencil_solver.py``).

The macro elements are RCM-ordered, so that every element's cross-macro
strip sources lie within a band of W macros, padded to a multiple of the
ranks, and cut into one contiguous block of U_loc macros a rank.  Each rank
holds, for every level, its block plus a halo of He macros on each side
(its extended domain, U_ext = U_loc + 2 He), and the serial block stencil's
rows of that domain as a ``StencilOperator``.  One ring exchange
(``comm.RingComm.ring_halo``) fills the halo, then kernel K1
(``ops.phase``) runs all the rounds of a smoothing phase on the extended
domain: the halo rows are relaxed redundantly, and after R rounds the
interior rows are bit for bit what the serial phase gives (the deep ghost
zone).  A phase of R rounds needs He = (R + 1) W; where twice that exceeds
``cfg.dist_ghost_max_frac`` of U_loc the rounds run in chunks of ``chunk``
with an exchange before each, on a geometry of He = chunk W for the chunks
that only advance x and (chunk + 1) W for the last, which also gives the
residual (``ghost_report`` counts the cost).  Every operator apply (the
Krylov operator, the Dirichlet offset, the theta < 1 right-hand side, the
coarse CG) is a zero-round K1 phase on the extended domain after one
exchange.  This replaces the JAX package's per-round strip exchange and its
one-hot tables, which were the TPU's matrix-unit gathers.

The smoothed-aggregation correction (``amg``, ``coarse_agg``) runs sharded:
the level-0 restriction as this rank's partial product over its own fine
columns, summed over the ranks (``all_reduce_sum``); the aggregation levels
with their block rows cut into one slice a rank and the iterate replicated
by ``all_gather`` after each apply.  Every one of those row products is a
kernel K2 ``RowOp`` (``ops.spmv``).  The multigrid transfers are
macro-local and never communicate; the coarsest geometric level solves
redundantly with the dense inverse after one ``all_gather``.

``mesh_shape=(hosts, chips)`` is checked against the world size; the ring
runs in rank order (host-major under torchrun) and the numerics do not
depend on the shape, so no two-dimensional mesh object is built.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SemiConfig, Solver
from ..mesh import topology
from ..models import semi
from ..ops import krylov
from ..ops.fused import from_t, to_t
from ..ops.phase import KERNEL, TIERS, phase_on_tier
from ..ops.spmv import RowOp
from ..ops.stencil import StencilData, StencilOperator, mul_blocks
from . import partition

# children a macro up to which the distributed solver builds its block
# stencil: the JAX package's cap, which its distributed solver shares.  The
# single-device cap (``SemiConfig.stencil_max_children``) goes further, to
# n_split 7; no distributed run at that depth has been made
DIST_MAX_CHILDREN = 4096


def _ext_data(data: StencilData, U: int, C: int, lo: int,
              U_ext: int) -> StencilData:
    """A rank's extended-domain slice of a level's stencil blocks.

    Rows are the globals ``clip(lo + [0, U_ext), 0, U - 1)``; positions
    outside the domain repeat its edge rows: their outputs are discarded
    and, by the construction of the remapped halo_src, interior rows never
    read them.
    """
    rows = np.clip(np.arange(lo, lo + U_ext), 0, U - 1)
    hs = np.asarray(data.halo_src)[rows]                 # (U_ext, nb) global
    src_u = np.clip(hs // C - lo, 0, U_ext - 1)          # ext coords
    return StencilData(
        self_blocks=data.self_blocks[rows],
        face_blocks=data.face_blocks[rows],
        cross_blocks=data.cross_blocks[rows],
        c_aff=data.c_aff[rows], halo_src=src_u * C + hs % C,
        bnd_c=data.bnd_c, bnd_f=data.bnd_f,
        intra_onehot=data.intra_onehot, cross_onehot=data.cross_onehot)


def band(data: StencilData) -> int:
    """W: the largest distance, in macros, from an element to the source
    of one of its strip slots."""
    hs = np.asarray(data.halo_src)
    if hs.size == 0:
        return 0
    C = data.self_blocks.shape[1]
    return int(np.abs(hs // C - np.arange(hs.shape[0])[:, None]).max())


def ghost_plan(W: int, R: int, U_loc: int, U: int, frac: float,
               D: int) -> tuple[int, int, int]:
    """(chunk, He, He_mid): the ghost depth and chunking of a level's
    phases of R rounds on D ranks of U_loc macros (U in all), band W.

    ``chunk`` is the largest k with 2 (k + 1) W within ``frac`` of U_loc
    (at least 1); the last chunk of a phase runs on He = (chunk + 1) W
    macros a side, the chunks before it, which only advance x, on He_mid =
    chunk W.  He_mid is He where the phases do not split or the band does
    not shrink (no mid geometry).  One rank or W = 0 needs no halo."""
    if D == 1 or W == 0:
        return R, 0, 0
    cap = max(frac, 0.0) * U_loc
    ks = [k for k in range(1, R + 1) if 2 * (k + 1) * W <= cap]
    chunk = max(ks) if ks else 1
    He = min((chunk + 1) * W, U)
    He_mid = min(chunk * W, U) if chunk < R else He
    return chunk, He, He_mid


def ghost_level(li: int, W: int, R: int, chunk: int, He: int, He_mid: int,
                U_loc: int) -> dict:
    """One level of ``ghost_report``: ``redundant_frac`` is the
    round-averaged fraction of extra ghost rows a round relaxes against a
    rank's interior, the chunks that only advance x on He_mid rows a side,
    the last chunk, of ``final = R - chunk ((R - 1) // chunk)`` rounds, on
    He; ``n_exchanges`` is the ring exchanges of x a phase (1: the classic
    deep ghost)."""
    final = R - chunk * ((R - 1) // chunk) if R else 0
    n_mid = R - final if He_mid < He else 0
    avg = 2.0 * (n_mid * He_mid + (R - n_mid) * He) / max(R, 1) / U_loc
    return dict(level=li, W=W, He=He, He_mid=He_mid, chunk=chunk, rounds=R,
                U_loc=U_loc, redundant_frac=round(avg, 4),
                n_exchanges=-(-R // chunk))


def level_rounds(serial: semi.SemiSolver, li: int) -> int:
    """The most rounds a phase of level li runs: its smoothing phases, and
    on the coarsest level of several also its coarse phase."""
    cfg = serial.cfg
    nl = len(serial.ops)
    R = len(serial._phase_coefs(li, cfg.n_smooth))
    if li == nl - 1 and nl > 1:
        R = max(R, len(serial._phase_coefs(li, cfg.coarse_sweeps)))
    return R


def ghost_model_at(serial: semi.SemiSolver, cfg: SemiConfig,
                   D: int) -> list[dict]:
    """The ghost report the distributed solver on D ranks would give, from
    its serial twin's levels (``ghost_plan`` and ``ghost_level``, as the
    solver's own ``ghost_report``): per level ``level, W, rounds, chunk,
    He, He_mid, U_loc, redundant_frac`` and ``deep_ghost_frac``, the
    redundant fraction of one deep-ghost chunk a phase.  U is the twin's,
    padded to a multiple of D as the solver pads it."""
    U_loc = -(-serial.ops[0].U // D)
    U = D * U_loc
    out = []
    for li, op in enumerate(serial.ops):
        W, R = band(op._data), level_rounds(serial, li)
        lv = ghost_level(li, W, R, *ghost_plan(
            W, R, U_loc, U, cfg.dist_ghost_max_frac, D), U_loc)
        del lv["n_exchanges"]
        lv["deep_ghost_frac"] = round(2 * min((R + 1) * W, U) / U_loc, 4)
        out.append(lv)
    return out


def _tier(op: StencilOperator, like: StencilOperator):
    """K1's tier for ``op`` on the card: the serial level ``like``'s tier
    wherever ``op`` fits it, so that both run the same code (None on the
    CPU, whose plain version has no tiers)."""
    if op.Fp_t.device.type != "cuda":
        return None
    want, auto = KERNEL.plan(like).tier, KERNEL.plan(op).tier
    return want if TIERS.index(auto) <= TIERS.index(want) else auto


@dataclasses.dataclass
class _Phase:
    """One level's extended-domain operators: ``op`` on the final
    geometry (He), ``op_mid`` on the geometry of the chunks that only
    advance x (He_mid), or None where He_mid is He (``ghost_plan``);
    ``tier``/``tier_mid`` are K1's tiers for each."""
    op: StencilOperator
    He: int
    He_mid: int
    chunk: int
    rounds: int
    W: int
    tier: str | None
    op_mid: StencilOperator | None = None
    tier_mid: str | None = None


class DistributedStencilSolver:
    """Sharded counterpart of ``models.semi.SemiSolver``'s stencil V-cycle.

    One instance on every rank of ``comm`` (a ``comm.RingComm``); the state
    is this rank's block (3, C, U_loc) of the transposed layout.  ``serial``
    is the serial twin on the same (reordered, padded) mesh and device:
    the distributed tables come from its stencil and SA hierarchy, and the
    tests hold the distributed solver to it.
    """

    def __init__(self, mesh: topology.MacroMesh, cfg: SemiConfig, comm,
                 mesh_shape=None):
        if cfg.solver not in (Solver.CHEBYSHEV, Solver.BLOCK_JACOBI):
            raise ValueError("distributed stencil solver needs the "
                             "Chebyshev or block-Jacobi smoother")
        if cfg.coarse_pack > 1:
            raise ValueError(
                "coarse_pack is a single-device layout option; the "
                "distributed level tables assume unpacked levels: run "
                "with coarse_pack=1")
        if not (cfg.stencil_operator
                and 4 ** cfg.n_split <= min(cfg.stencil_max_children,
                                            DIST_MAX_CHILDREN)):
            raise ValueError("stencil operator disabled for this config")
        if cfg.debug:
            raise ValueError("the checked step (debug) runs on one device "
                             "only")
        D = comm.world
        if mesh_shape is not None:
            h, c = mesh_shape
            if h * c != D:
                raise ValueError(f"mesh_shape {mesh_shape} != {D} ranks")
        self.mesh_shape = mesh_shape
        self.comm = comm
        self.D = D
        self.device = comm.device

        mesh = topology.reorder_elements(mesh, topology.rcm_order(mesh))
        mesh, self.n_active = partition.pad_mesh(mesh, D)
        self.U = mesh.num_elements
        self.U_loc = self.U // D
        self.lo = comm.rank * self.U_loc

        self.cfg = cfg
        self.p = semi.build_problem(mesh, cfg)
        self.serial = semi.SemiSolver(self.p, self.device)
        self.krylov_iters: list[int] = []

        nl = len(self.p.levels)
        self._coefs = [self.serial._phase_coefs(li, cfg.n_smooth)
                       for li in range(nl)]
        self._coefs_coarse = self.serial._phase_coefs(
            nl - 1, cfg.coarse_sweeps if nl > 1 else cfg.n_smooth)
        self._phases = [self._build_phase(li) for li in range(nl)]
        # this rank's columns of each level's self blocks, their inverses
        # and the Dirichlet offset, and of the fine right-hand side's tables
        cols = slice(self.lo, self.lo + self.U_loc)
        self._loc = [{name: getattr(op, name)[..., cols].contiguous()
                      for name in ("S_t", "Dinv_t", "c_aff_t")}
                     for op in self.serial.ops]
        self.M_t = self.serial.M_t[..., cols].contiguous()
        self.source_t = self.serial.source_t[..., cols].contiguous()
        self._agg_li = self.serial._agg_li
        self._build_agg_dist()

    # -- setup: extended-domain operators -----------------------------------
    def _build_phase(self, li: int) -> _Phase:
        """Level li's ghost depth, chunking (``ghost_plan``) and
        extended-domain operators (the JAX package's ``_build_phases``).
        A geometry that does not build raises."""
        serial_op = self.serial.ops[li]
        W, R = band(serial_op._data), level_rounds(self.serial, li)
        chunk, He, He_mid = ghost_plan(W, R, self.U_loc, self.U,
                                       self.cfg.dist_ghost_max_frac, self.D)
        if self.D == 1:
            return _Phase(serial_op, He, He_mid, chunk, R, W,
                          _tier(serial_op, serial_op))

        def geometry(H):
            op = StencilOperator(
                _ext_data(serial_op._data, self.U, serial_op.C,
                          self.lo - H, self.U_loc + 2 * H),
                self.serial.dtype, self.device)
            return op, _tier(op, serial_op)

        op, tier = geometry(He)
        ph = _Phase(op, He, He_mid, chunk, R, W, tier)
        if He_mid < He:
            ph.op_mid, ph.tier_mid = geometry(He_mid)
        return ph

    def ghost_report(self) -> list[dict]:
        """Per level, the deep-ghost cost of the sharded phases
        (``ghost_level``)."""
        return [ghost_level(li, ph.W, ph.rounds, ph.chunk, ph.He, ph.He_mid,
                            self.U_loc)
                for li, ph in enumerate(self._phases)]

    # -- setup: the sharded SA hierarchy --------------------------------------
    def _build_agg_dist(self):
        """This rank's K2 operators of the SA correction.

        Level 0's restriction keeps only the slots of this rank's own fine
        columns (compacted, local column ids) and the band of aggregates
        they reach, zero-padded after the product to all the aggregates
        (a multiple of the ranks); the prolongation is this rank's slice
        of fine rows.  The aggregation levels' operators, restrictions and
        prolongations are this rank's slice of block rows (rows padded to
        a multiple of the ranks); they read the replicated iterate."""
        self._agg = None
        h = self.serial._agg_host
        if h is None or self.D == 1:
            # one rank: the serial correction (factored transfers) runs
            return
        D, d = self.D, self.comm.rank
        dt, dev = self.serial.dtype, self.device
        C_li = self.serial.ops[self._agg_li].C
        E_loc = self.U_loc * C_li

        lvl0 = h.levels[0]
        r_cols = np.asarray(lvl0.r_cols)                 # (na, Dr) fine ids
        r_vals = np.asarray(lvl0.r_vals)
        Npad0 = D * -(-lvl0.n // D)
        # this rank's slots: its own fine columns, padding (zero blocks) not
        mine = ((r_cols // E_loc) == d) & (np.abs(r_vals).max((2, 3)) > 0)
        # the aggregates they reach, a band in the RCM order: the partial
        # product's rows, zero-padded to all Npad0 before the sum
        hit = np.flatnonzero(mine.any(axis=1))
        r_lo = int(hit[0]) if hit.size else 0
        r_hi = int(hit[-1]) + 1 if hit.size else 1
        self._l0_pad = (r_lo, Npad0 - r_hi)
        mine, r_cols, r_vals = (a[r_lo:r_hi] for a in (mine, r_cols, r_vals))
        # this rank's slots first, in their order, then the others
        order = np.argsort(~mine, axis=1, kind="stable")
        width = max(int(mine.sum(axis=1).max()), 1)
        sel = np.take_along_axis(mine, order, 1)[:, :width]
        rc_cols = np.where(
            sel, np.take_along_axis(r_cols, order, 1)[:, :width] - d * E_loc,
            0)
        rc_vals = np.where(
            sel[..., None, None],
            np.take_along_axis(r_vals, order[..., None, None], 1)[:, :width],
            0)
        rows = slice(d * E_loc, (d + 1) * E_loc)
        self._l0_rc = RowOp(rc_cols, rc_vals, E_loc, dt, dev)
        self._l0_p = RowOp(np.asarray(lvl0.p_cols)[rows],
                           np.asarray(lvl0.p_vals)[rows], Npad0, dt, dev)

        def rows_of(a, n_loc):
            """Rows of ``a`` padded with zeros to D n_loc; this rank's
            n_loc of them."""
            padded = np.zeros((D * n_loc,) + a.shape[1:], a.dtype)
            padded[:len(a)] = a
            return padded[d * n_loc:(d + 1) * n_loc]

        self._agg = []
        for k, lvl in enumerate(h.levels):
            N_loc = -(-lvl.n // D)
            t = dict(n=lvl.n, N_loc=N_loc, omega=min(lvl.omega, h.omega),
                     op=RowOp(rows_of(np.asarray(lvl.cols), N_loc),
                              rows_of(np.asarray(lvl.vals), N_loc),
                              D * N_loc, dt, dev),
                     dinv_t=torch.as_tensor(np.ascontiguousarray(
                         rows_of(np.asarray(lvl.dinv), N_loc
                                 ).transpose(1, 2, 0)), device=dev))
            if k > 0:
                Np_loc = -(-h.levels[k - 1].n // D)
                t["rstr"] = RowOp(rows_of(np.asarray(lvl.r_cols), N_loc),
                                  rows_of(np.asarray(lvl.r_vals), N_loc),
                                  D * Np_loc, dt, dev)
                t["prol"] = RowOp(rows_of(np.asarray(lvl.p_cols), Np_loc),
                                  rows_of(np.asarray(lvl.p_vals), Np_loc),
                                  D * N_loc, dt, dev)
            self._agg.append(t)
        tens = lambda a: (None if a is None else torch.as_tensor(
            np.asarray(a), device=dev))
        self._coarse_inv = tens(h.coarse_inv)
        self._coarse_scale = tens(h.coarse_scale)
        self._agg_sweeps = h.sweeps

    def rowops(self) -> dict:
        """This rank's K2 operators of the sharded SA correction by name
        (empty on one rank or without SA levels)."""
        if self._agg is None:
            return {}
        out = {"l0_rc": self._l0_rc, "l0_p": self._l0_p}
        for k, t in enumerate(self._agg):
            out[f"l{k}_op"] = t["op"]
            if k:
                out[f"l{k}_r"], out[f"l{k}_p"] = t["rstr"], t["prol"]
        return out

    # -- numerics -------------------------------------------------------------
    def _cols(self, ph: _Phase, t):
        """This rank's interior columns of an extended-domain tensor."""
        return t[..., ph.He:ph.He + self.U_loc].contiguous()

    def _halo(self, t, H):
        """t on the extended domain of H macros a side."""
        if H == 0:
            return t
        left, right = self.comm.ring_halo(t, H)
        return torch.cat([left, t, right], dim=-1)

    def _bp_ext(self, li, b_t, with_bc):
        """The premultiplied right-hand side D^-1 (b - c_aff) of level li
        on the final geometry's extended domain: one exchange, shared by
        every phase with this b."""
        loc = self._loc[li]
        b = b_t - loc["c_aff_t"] if with_bc else b_t
        return self._halo(mul_blocks(loc["Dinv_t"], b), self._phases[li].He)

    def _phase_dist(self, li, x_t, bp_ext, coefs, want_z: bool = True):
        """One smoothing phase of level li (coefs not empty) on this
        rank's extended domain, from ``_bp_ext``'s bp: (x_new, z or None)
        on the interior, bit for bit the serial phase's (the halo rows are
        relaxed redundantly with the same arithmetic).  The rounds run in
        chunks with a ring exchange of x before each: every chunk's
        interior equals the serial state after those rounds, so the
        refilled halos are exact and chunking never changes the answer."""
        ph = self._phases[li]
        if ph.op_mid is not None:
            off = ph.He - ph.He_mid
            bp_mid = bp_ext[..., off:off + self.U_loc + 2 * ph.He_mid
                            ].contiguous()
        n = len(coefs)
        for g0 in range(0, n, ph.chunk):
            last = g0 + ph.chunk >= n
            if last or ph.op_mid is None:
                H, op, bp, tier = ph.He, ph.op, bp_ext, ph.tier
            else:
                H, op, bp, tier = ph.He_mid, ph.op_mid, bp_mid, ph.tier_mid
            x_new, z = phase_on_tier(op, self._halo(x_t, H), bp,
                                     coefs[g0:g0 + ph.chunk],
                                     want_z and last, tier)
            x_t = x_new[..., H:H + self.U_loc].contiguous()
        return x_t, (None if z is None else
                     z[..., H:H + self.U_loc].contiguous())

    def _apply_t(self, li, x_t, with_bc: bool = False):
        """A x on this rank's block: a zero-round phase on the extended
        domain after one exchange of x, A x = -D z."""
        ph, loc = self._phases[li], self._loc[li]
        x_ext = self._halo(x_t, ph.He)
        _, z = phase_on_tier(ph.op, x_ext, torch.zeros_like(x_ext), [], True,
                             ph.tier)
        ax = -mul_blocks(loc["S_t"], self._cols(ph, z))
        return ax + loc["c_aff_t"] if with_bc else ax

    def _pdot(self, a, b):
        """Inner product summed over the ranks."""
        return self.comm.all_reduce_sum(torch.sum(a * b))

    def _coarse_cg(self, li, x_t, b_t):
        """coarse_krylov: block-Jacobi PCG with all-reduced dots (the
        serial ``_coarse_cg_t``)."""
        Dinv = self._loc[li]["Dinv_t"]
        x_sol, _, _ = krylov.pcg(
            lambda v: self._apply_t(li, v, False), b_t, x_t,
            precond=lambda r: mul_blocks(Dinv, r), tol=0.0,
            maxiter=self.cfg.coarse_sweeps, dot=self._pdot)
        return x_sol

    # -- the sharded SA correction --------------------------------------------
    def _ag(self, y_loc):
        return self.comm.all_gather(y_loc, -1)

    def _agg_b_loc(self, t, b_rep):
        d = self.comm.rank
        return b_rep[:, d * t["N_loc"]:(d + 1) * t["N_loc"]]

    def _agg_smooth(self, k, x_rep, b_rep, sweeps):
        t = self._agg[k]
        b_loc = self._agg_b_loc(t, b_rep)
        for _ in range(sweeps):
            r_loc = b_loc - t["op"](x_rep)
            x_rep = x_rep + t["omega"] * self._ag(
                mul_blocks(t["dinv_t"], r_loc))
        return x_rep

    def _agg_vcycle(self, k, b_rep):
        """The SA V-cycle (``ops.agg.vcycle``) with sharded rows and a
        replicated iterate, from a zero start."""
        t = self._agg[k]
        sweeps = self._agg_sweeps
        # the first sweep from zero: its residual is b
        x = t["omega"] * self._ag(
            mul_blocks(t["dinv_t"], self._agg_b_loc(t, b_rep)))
        if sweeps > 1:
            x = self._agg_smooth(k, x, b_rep, sweeps - 1)
        r_loc = self._agg_b_loc(t, b_rep) - t["op"](x)
        if k + 1 < len(self._agg):
            nxt = self._agg[k + 1]
            rc_loc = nxt["rstr"](self._ag(r_loc))
            ec = self._agg_vcycle(k + 1, self._ag(rc_loc))
            x = x + self._ag(nxt["prol"](ec))
        elif self._coarse_inv is not None:
            n = t["n"]
            rs = self._coarse_scale * self._ag(r_loc)[:, :n].T.reshape(-1)
            ec = self._coarse_scale * (self._coarse_inv @ rs)
            x = x + torch.nn.functional.pad(ec.reshape(n, 3).T,
                                            (0, x.shape[1] - n))
        return self._agg_smooth(k, x, b_rep, sweeps)

    def _agg_correct(self, x_t, r_t):
        """SA correction of the SA level's local residual (3, C, U_loc)."""
        if self._agg is None:
            return self.serial._agg_correct_t(self._agg_li, x_t, r_t)
        C = r_t.shape[1]
        r_loc = r_t.transpose(1, 2).reshape(3, self.U_loc * C)  # e = u*C + c
        rc = self.comm.all_reduce_sum(torch.nn.functional.pad(
            self._l0_rc(r_loc.contiguous()), self._l0_pad))
        e = self._agg_vcycle(0, rc)
        for _ in range(self.cfg.agg_cycles - 1):
            e = e + self._agg_vcycle(0, rc - self._ag(self._agg[0]["op"](e)))
        e_loc = self._l0_p(e).reshape(3, self.U_loc, C).transpose(1, 2)
        return x_t + e_loc

    # -- V-cycle --------------------------------------------------------------
    def _vcycle_t(self, li, x_t, b_t, hom: bool = False):
        """The serial ``SemiSolver._vcycle_t`` on this rank's block."""
        cfg = self.cfg
        nl = len(self.p.levels)
        with_bc = li == 0 and not hom
        sa_level = self._agg_li is not None and li == self._agg_li
        coarsest = li == nl - 1 and not sa_level
        if coarsest and nl > 1 and self.serial.coarse_inv_t is not None:
            full = self.comm.all_gather(b_t, -1)            # (3, C, U)
            x_full = (self.serial.coarse_inv_t @ full.reshape(-1)
                      ).reshape(full.shape)
            return x_full[..., self.lo:self.lo + self.U_loc].contiguous()
        if coarsest and nl > 1 and cfg.coarse_krylov:
            return self._coarse_cg(li, x_t, b_t)
        bp_ext = self._bp_ext(li, b_t, with_bc)
        S_loc = self._loc[li]["S_t"]

        def smooth(x, coefs, want_z=False):
            x, z = self._phase_dist(li, x, bp_ext, coefs, want_z)
            return (x, z) if want_z else x

        if coarsest:
            return smooth(x_t, self._coefs_coarse)
        coefs = self._coefs[li]
        x_t, z_t = smooth(x_t, coefs, True)          # the residual is S z
        if sa_level:
            # the finest level in amg mode, else the geometric coarsest
            x_t = self._agg_correct(x_t, mul_blocks(S_loc, z_t))
        else:
            bc_ = self.serial._restrict_t(z_t, li + 1, S_loc)
            e_t = self._vcycle_t(li + 1, torch.zeros_like(bc_), bc_, hom)
            if cfg.cycle_type == "w" and li < 2:
                e_t = self._vcycle_t(li + 1, e_t, bc_, hom)
            x_t = self.serial._prolong_add_t(x_t, e_t, li + 1)
        return smooth(x_t, coefs)

    # -- time stepping --------------------------------------------------------
    def _rhs_t(self, T_t):
        """b = M T/dt + M s - (1 - theta) L(T) on this rank's block, with
        L(T) = (A T - M T/dt) / theta from one zero-round apply."""
        cfg = self.cfg

        def mul_M(v_t):
            return (self.M_t[:, :, None, :] * v_t[None]).sum(dim=1)
        b_t = mul_M(T_t) / cfg.dt + mul_M(self.source_t)
        if cfg.theta < 1.0:
            Ax = self._apply_t(0, T_t, True)
            spat = (Ax - mul_M(T_t) / cfg.dt) / cfg.theta
            b_t = b_t - (1.0 - cfg.theta) * spat
        return b_t

    def step(self, T_t):
        """One theta-scheme time step: n_multigrid V-cycles, or the
        V-cycle-preconditioned PCG (BiCGStab under advection) with dots
        summed over the ranks; Krylov iteration counts go to
        ``krylov_iters``."""
        cfg = self.cfg
        b_t = self._rhs_t(T_t)
        if cfg.krylov:
            c = self._apply_t(0, torch.zeros_like(b_t), True)
            method = (krylov.bicgstab if cfg.physics.advection
                      else krylov.pcg)
            T_t, it, _ = method(
                lambda x: self._apply_t(0, x, False), b_t - c, T_t,
                precond=lambda r: self._vcycle_t(0, torch.zeros_like(r), r,
                                                 hom=True),
                tol=cfg.krylov_tol, maxiter=cfg.krylov_maxiter,
                dot=self._pdot)
            self.krylov_iters.append(it)
            return T_t
        for _ in range(cfg.n_multigrid):
            T_t = self._vcycle_t(0, T_t, b_t)
        return T_t

    # -- public API -----------------------------------------------------------
    def _block(self, T_std: torch.Tensor):
        """This rank's block (3, C, U_loc) of a full (U, C, 3) state."""
        return to_t(T_std)[..., self.lo:self.lo + self.U_loc].contiguous()

    def initial_condition(self):
        return self._block(self.serial.initial_condition())

    def run(self, T_t=None, ntime=None):
        if T_t is None:
            T_t = self.initial_condition()
        for _ in range(ntime or self.cfg.ntime):
            T_t = self.step(T_t)
        return T_t

    def to_std(self, T_t) -> np.ndarray:
        """The whole active state (U_active, C, 3), numpy, on every rank
        (a collective: every rank calls it)."""
        full = from_t(self.comm.all_gather(T_t, -1))
        return full[: self.n_active].cpu().numpy()

    def save_checkpoint(self, path: str, T_t, step: int) -> None:
        """Rank 0 writes the state in the standard unpadded layout, which
        the serial solvers and the JAX package read (a collective)."""
        from ..io import checkpoint as ckpt
        T = self.to_std(T_t)
        if self.comm.rank == 0:
            ckpt.save(path, T, step, self.cfg)
        self.comm.barrier()

    def load_checkpoint(self, path: str):
        """(this rank's block, step) from a checkpoint that a serial or a
        distributed run of either package wrote."""
        from ..io import checkpoint as ckpt
        T_np, step, _, _ = ckpt.load(path)
        full = np.zeros((self.U,) + T_np.shape[1:], T_np.dtype)
        full[: self.n_active] = T_np
        return self._block(torch.as_tensor(full, dtype=self.serial.dtype,
                                           device=self.device)), step

    def error(self, T_t) -> np.ndarray:
        ana = np.asarray(self.p.analytical)[: self.n_active]
        return np.abs(self.to_std(T_t) - ana)

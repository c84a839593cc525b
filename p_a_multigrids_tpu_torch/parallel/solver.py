"""Distributed semi-structured multigrid solver over the general operator
(port of the JAX package's ``parallel/solver.py``).

Row-partitions ``models.semi``'s solver across the ranks of a
``comm.RingComm``: macro elements are split into contiguous BFS blocks
(``partition``), every level's tables are cut to this rank's block, and the
only communication is the halo ``all_gather`` of partition-boundary face
strips (``halo``) inside ``models.semi.apply_A``.  The multigrid transfers
are macro-local, so restriction and prolongation need no communication;
the coarsest-level direct solve gathers its small right-hand side to every
rank and applies the replicated dense inverse redundantly.

Plain PyTorch throughout, as it was XLA in the JAX package: this path runs
no kernel.  ``parallel.stencil_solver`` is the fast path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SemiConfig, Solver
from ..mesh.topology import MacroMesh
from ..models import semi
from ..ops import smoothers
from ..ops.fused import from_t, to_t
from . import halo, partition

# level tables with a leading macro (U) axis: cut to this rank's block
_U_KEYS = ("M", "ml", "D", "K", "nx1", "sdet", "snorm", "inv_dx", "diff_on",
           "neu_mask", "bc_dense", "neigh_elem", "neigh_perm")


class DistributedSemiSolver:
    """Distributed counterpart of ``models.semi.SemiSolver`` on the
    general operator (``apply_A`` with a halo gather); one instance on
    every rank of ``comm``, each holding its block of the state
    (U_loc, C, 3)."""

    def __init__(self, mesh: MacroMesh, cfg: SemiConfig, comm):
        self.comm = comm
        D = comm.world
        self.device = comm.device
        self.part = partition.partition_mesh(mesh, D)
        self.cfg = cfg
        self.p = semi.build_problem(self.part.mesh, cfg)
        # the serial solver supplies the setup-time spectra and inverses
        self._serial = semi.SemiSolver(self.p, self.device)
        self.U_loc = self.part.block
        lo, hi = comm.rank * self.U_loc, (comm.rank + 1) * self.U_loc
        self._rows = slice(lo, hi)
        self.levels = []
        for li, L in enumerate(self.p.levels):
            Lt = semi.level_tensors(L, self.device)
            Ld = {k: (v[lo:hi] if k in _U_KEYS else v) for k, v in Lt.items()}
            Ld["gather"] = halo.make_gather(
                halo.build_halo_plan(np.asarray(L["neigh_elem"]), D), comm,
                self.device)
            if cfg.solver in (Solver.BLOCK_JACOBI, Solver.CHEBYSHEV):
                if self._serial._block_inv is not None:
                    Ld["block_inv"] = self._serial._block_inv[li][lo:hi]
                else:
                    # stencil path: the exact diagonal blocks' inverses
                    Ld["block_inv"] = self._serial.ops[li].Dinv_t.permute(
                        3, 2, 0, 1)[lo:hi]
            self.levels.append(Ld)
        self.source = torch.tensor(self.p.levels[0]["source"][lo:hi],
                                   device=self.device)
        inv = self._serial._coarse_inv_np
        self.coarse_inv = (None if inv is None else
                           torch.as_tensor(inv, device=self.device))

    # -- distributed numerics ----------------------------------------------
    def _A(self, li, with_bc):
        L, cfg = self.levels[li], self.cfg
        return lambda t: semi.apply_A(L, cfg.physics, cfg.dt, cfg.theta, t,
                                      with_bc, L["gather"])

    def _smooth(self, li, x, b, sweeps, with_bc):
        cfg = self.cfg
        L = self.levels[li]
        A = self._A(li, with_bc)
        if cfg.solver in (Solver.CHEBYSHEV, Solver.BLOCK_JACOBI):
            Ainv = L["block_inv"]
            solve = lambda r: torch.einsum("ucij,ucj->uci", Ainv, r)
            if cfg.solver == Solver.CHEBYSHEV:
                return smoothers.chebyshev(
                    A, b, x, solve, self._serial._cheb_roots(li),
                    max(1, sweeps // cfg.cheb_degree))
            return smoothers.block_jacobi_solve(A, b, x, solve, cfg.omega,
                                                sweeps)
        d = semi.diag_A(L, cfg.physics, cfg.dt, cfg.theta)
        return smoothers.jacobi(A, b, x, d, cfg.omega, sweeps)

    def _vcycle(self, li, x, b):
        cfg = self.cfg
        nl = len(self.levels)
        with_bc = li == 0
        if li == nl - 1:
            if nl > 1 and self.coarse_inv is not None:
                # gather the coarse right-hand side from every rank and
                # solve redundantly
                full = self.comm.all_gather(b, 0)
                x_full = (self.coarse_inv @ full.reshape(-1)).reshape(
                    full.shape)
                return x_full[self._rows]
            return self._smooth(li, x, b,
                                cfg.coarse_sweeps if nl > 1 else cfg.n_smooth,
                                with_bc)
        x = self._smooth(li, x, b, cfg.n_smooth, with_bc)
        r = b - self._A(li, with_bc)(x)
        bc_ = from_t(self._serial._restrict_t(to_t(r), li + 1))
        e = self._vcycle(li + 1, torch.zeros_like(bc_), bc_)
        x = from_t(self._serial._prolong_add_t(to_t(x), to_t(e), li + 1))
        return self._smooth(li, x, b, cfg.n_smooth, with_bc)

    def step(self, T):
        """One theta-scheme time step of this rank's block (U_loc, C, 3)."""
        cfg = self.cfg
        L0 = self.levels[0]
        Ms = torch.einsum("uij,ucj->uci", L0["M"], self.source)
        b = torch.einsum("uij,ucj->uci", L0["M"], T) / cfg.dt + Ms
        if cfg.theta < 1.0:
            b = b - (1.0 - cfg.theta) * semi.apply_spatial(
                L0, cfg.physics, T, True, L0["gather"])
        for _ in range(cfg.n_multigrid):
            T = self._vcycle(0, T, b)
        return T

    # -- public API --------------------------------------------------------
    def initial_condition(self):
        """This rank's block of the initial condition."""
        return self._serial.initial_condition()[self._rows].contiguous()

    def run(self, T=None, ntime=None):
        if T is None:
            T = self.initial_condition()
        for _ in range(ntime or self.cfg.ntime):
            T = self.step(T)
        return T

    def active(self, T) -> np.ndarray:
        """Every rank's block gathered, the padding elements sliced away
        (numpy, on every rank)."""
        full = self.comm.all_gather(T, 0)
        return full[: self.part.n_active].cpu().numpy()

    def error(self, T) -> np.ndarray:
        return np.abs(self.active(T)
                      - np.asarray(self.p.analytical)[: self.part.n_active])

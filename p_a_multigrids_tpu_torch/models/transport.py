"""Triangular-mesh DG transport solvers (modes 2-6), port of the JAX
package's ``models/transport.py``.

Plain DG on a macro mesh is the semi-structured hierarchy at split depth 0
(one child per element, C = 1), so every mode here is a configuration of
``models.semi.SemiSolver``:

- explicit modes (2, 4): theta = 0, where A = M/dt is block-diagonal, so one
  exact block-Jacobi round per step (one K1 launch on the GPU) is the whole
  update;
- implicit modes (3, 5, 6): the theta-scheme (Crank-Nicolson by default)
  solved by V-cycle-preconditioned PCG, or BiCGStab under advection, with a
  Rannacher start of two theta = 1 steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import Physics, ProblemFns, SemiConfig, Solver, TransportConfig
from ..mesh.topology import MacroMesh
from . import semi


def _semi_cfg(cfg: TransportConfig, fns: ProblemFns) -> SemiConfig:
    dt = cfg.dt if cfg.dt is not None else cfg.cfl * cfg.dx
    phys = Physics(
        advection=any(abs(u) > 0 for u in cfg.u),
        diffusion=cfg.diffusion or cfg.k != 0.0,
        surface_terms=True,
        k=cfg.k if cfg.k else 1.0,
        u=cfg.u,
    )
    if not cfg.implicit:
        # explicit: A = M/dt is block-diagonal; one exact block solve per
        # element IS the update
        return SemiConfig(
            n_split=0, multi_levels=1, n_multigrid=1, n_smooth=1,
            ntime=cfg.ntime, dt=dt, theta=0.0, omega=1.0,
            solver=Solver.BLOCK_JACOBI, physics=phys, manufactured=False,
            fns=fns, dtype=cfg.dtype)
    return SemiConfig(
        n_split=0, multi_levels=1, n_multigrid=2, n_smooth=12,
        ntime=cfg.ntime, dt=dt, theta=cfg.theta,
        solver=Solver.CHEBYSHEV, physics=phys, manufactured=False,
        krylov=True, fns=fns, dtype=cfg.dtype)


def solve(mesh: MacroMesh, cfg: TransportConfig | None = None,
          fns: ProblemFns | None = None, ic: np.ndarray | None = None,
          device="cuda"):
    """Run a DG transport solve on ``device``; returns (solver, T), T of
    shape (U, 1, 3).

    ``fns`` supplies Dirichlet BC / source / analytical / IC callables;
    ``ic`` overrides the initial state directly (U, 1, 3).  With Rannacher
    on, an implicit theta < 1 run of more than two steps takes its first
    two steps with theta = 1, by a second solver on the same problem.
    """
    cfg = cfg or TransportConfig()
    scfg = _semi_cfg(cfg, fns or ProblemFns())
    problem = semi.build_problem(mesh, scfg)
    solver = semi.SemiSolver(problem, device)
    T = (solver.initial_condition() if ic is None
         else solver.analytical.new_tensor(np.asarray(ic)))
    nstart = 0
    if cfg.implicit and cfg.rannacher and cfg.theta < 1.0 and cfg.ntime > 2:
        be_cfg = dataclasses.replace(scfg, theta=1.0)
        be_solver = semi.SemiSolver(dataclasses.replace(problem, cfg=be_cfg),
                                    device)
        nstart = 2
        T = be_solver.run(T, ntime=nstart)
    T = solver.run(T=T, ntime=cfg.ntime - nstart)
    return solver, T


@dataclasses.dataclass
class BreakthroughSetup:
    """The erfc advection-diffusion validation configuration.

    1-D breakthrough problem on a strip: T=1 injected at the x=0 inlet,
    u=(gamma*k, 0), validated against the closed-form erfc transient
    solution used by the reference's gate scripts
    (Check_thermal_analytical_validation.py:34-43).
    """
    gamma: float = 1.0
    k: float = 1.0
    t_end: float = 0.1


def breakthrough_fns(setup: BreakthroughSetup,
                     x_len: float = 2.0) -> ProblemFns:
    """Inlet T=1 at x=0, Dirichlet 0 at the x=x_len outlet, no-flux side
    walls — the 1-D column the erfc solution describes."""
    tol = 1e-9

    def bc(x, y):
        return np.where(np.asarray(x) < tol, 1.0, 0.0)

    def neumann(x, y):
        x = np.asarray(x)
        return (x > tol) & (x < x_len - tol)

    return ProblemFns(bc=bc, neumann=neumann,
                      ic=lambda x, y: np.zeros_like(np.asarray(x)))

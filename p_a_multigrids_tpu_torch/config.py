"""Run configuration of the semi-structured solver and of the triangular-mesh
transport solvers (mirror of the JAX package's ``config.py``, same fields
and defaults).

Fields of paths this port does not run yet are left out.  ``debug`` makes
the solver's step a checked step (``utils.debugging``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

# scalar field callables take numpy arrays (x, y) and return an array
FieldFn = Callable


@dataclasses.dataclass
class ProblemFns:
    """Optional problem-defining callables (evaluated host-side at setup).

    When unset and ``manufactured`` is on, the sin(x+y) manufactured
    solution supplies all of them.
    """
    bc: FieldFn | None = None          # Dirichlet ghost values g(x, y)
    source: FieldFn | None = None      # volume source s(x, y)
    analytical: FieldFn | None = None  # exact solution for error fields
    ic: FieldFn | None = None          # initial condition T0(x, y)
    # (x, y) of a boundary-face midpoint -> True where the face is no-flux
    # (homogeneous Neumann) instead of weak Dirichlet.  None = all Dirichlet.
    neumann: FieldFn | None = None


class Solver(enum.Enum):
    JACOBI = "jacobi"
    RICHARDSON = "richardson"
    GAUSS_SEIDEL = "gauss_seidel"
    BLOCK_JACOBI = "block_jacobi"  # exact 3x3 block solves
    CHEBYSHEV = "chebyshev"        # Chebyshev-accelerated block-Jacobi
    DIRECT = "direct"


@dataclasses.dataclass
class Physics:
    """Term toggles of the DG operator."""
    advection: bool = False
    diffusion: bool = True
    # upwind advection flux + interior-penalty diffusion on faces
    surface_terms: bool = True
    # full symmetric-interior-penalty consistency/symmetry terms (False
    # reproduces the Fortran reference's penalty-only scheme)
    sip_consistency: bool = True
    # SIP eta; 3.0 is the P1 trace-constant bound with |F|/|E| scaling
    penalty_factor: float = 3.0
    k: float = 1.0                 # diffusion coefficient
    u: tuple[float, float] = (0.0, 0.0)


@dataclasses.dataclass
class SemiConfig:
    """Semi-structured multigrid transport solve (mode 9 in this port)."""
    n_split: int = 1
    multi_levels: int = 1
    n_multigrid: int = 2           # V-cycles per time step
    n_smooth: int = 4              # pre/post smoothing sweeps
    coarse_sweeps: int = 15        # coarsest-level smoother iterations
    ntime: int = 2
    dt: float = 1.25e-5
    theta: float = 1.0             # 1 implicit, 1/2 Crank-Nicolson, 0 explicit
    omega: float = 0.8             # block-Jacobi relaxation weight
    solver: Solver = Solver.CHEBYSHEV
    # Chebyshev smoothing interval [cheb_lower*lam_max, lam_max] of the
    # block-preconditioned operator; degree = rounds per smoothing phase
    cheb_degree: int = 6
    cheb_lower: float = 0.1
    # coarsest level: exact dense inverse when it has at most this many DOF
    coarse_direct_max_dof: int = 4096
    # smoothed-aggregation (SA) levels below a geometric coarsest that is
    # too large for the dense inverse (ops/agg.py)
    coarse_agg: bool = True
    agg_sweeps: int = 2            # block-Jacobi sweeps per SA level
    agg_cycles: int = 1            # SA V-cycles per correction
    agg_dense_max_dof: int = 4096  # dense inverse at the SA bottom
    # SA filtering: blocks below drop_tol * sqrt(|diag_i||diag_j|) are
    # dropped from the Galerkin level operators
    agg_drop_tol: float = 1e-4
    agg_target: int = 4            # elements per aggregate (BFS target)
    # strength-of-connection threshold of the aggregation graph (0 = raw
    # adjacency); dropping weak couplings semicoarsens along anisotropy
    agg_strength: float = 0.4
    # the SA hierarchy corrects the finest level directly (geometric
    # coarse levels bypassed): the robust choice on anisotropic meshes
    amg: bool = False
    cycle_type: str = "v"          # "w" recurses twice at the top two pairs
    # coarsest level by block-Jacobi PCG instead of stationary sweeps
    coarse_krylov: bool = False
    # V-cycle-preconditioned Krylov per time step: PCG without advection,
    # BiCGStab with it
    krylov: bool = False
    krylov_tol: float = 1e-8
    krylov_maxiter: int = 200
    # transposed-layout term-by-term operator (ops/fused.py) on the
    # non-stencil path; False applies models.semi.apply_A instead
    fast_operator: bool = True
    # exact block-stencil operator (ops/stencil.py), built when 4**n_split
    # <= stencil_max_children; above it (n_split >= 8) the non-stencil path
    # runs.  stencil_probe builds the blocks by basis probing of apply_A
    # instead of the closed form.  The cap is the port's one departure from
    # the JAX package's defaults (4096 there, where the TPU's stencil cost
    # outgrew its benefit): 4**7, the deepest split of the reference's
    # scaling study, whose fine level kernel K1 streams
    stencil_operator: bool = True
    stencil_probe: bool = False
    stencil_max_children: int = 16384
    # macro-pack factor of coarse levels.  A pure relabeling whose only
    # purpose was fewer TPU grid steps; the port accepts it and does not
    # pack (results equal the packed run, tests/test_torch_semi.py).
    coarse_pack: int = 1
    # one coarse-level Chebyshev polynomial of this degree (and lower
    # bound) instead of repeating the fine one
    coarse_cheb_degree: int | None = None
    coarse_cheb_lower: float | None = None
    coarse_operator: str = "geometric"   # or "galerkin" (P^T A P)
    # distributed stencil solver: a smoothing phase's ghost rows (2 He a
    # rank) at most this fraction of the rank's U_loc macros, or its rounds
    # run in chunks with a halo exchange before each (parallel/)
    dist_ghost_max_frac: float = 0.25
    restrictor: str = "linear"           # or "corner_average"
    physics: Physics = dataclasses.field(default_factory=Physics)
    manufactured: bool = True
    fns: ProblemFns = dataclasses.field(default_factory=ProblemFns)
    dtype: str = "float32"
    debug: bool = False                  # the checked step (utils/debugging)


@dataclasses.dataclass
class RectConfig:
    """Structured rectangular DG advection (mode 1)."""
    no_ele_row: int = 200
    no_ele_col: int = 1
    x_length: float = 100.0
    y_length: float = 100.0
    cfl: float = 0.7
    time: float = 250.0
    nits: int = 2                  # nonlinearity iterations
    njac_its: int = 10
    u: tuple[float, float] = (2 * 0.01428571, 0.0)
    direct_solver: bool = False
    dtype: str = "float32"


@dataclasses.dataclass
class TransportConfig:
    """Triangular-mesh DG transport (modes 2-6)."""
    cfl: float = 0.7
    ntime: int = 2
    dt: float | None = None        # defaults to cfl*dx
    dx: float = 0.1
    nits: int = 2
    njac_its: int = 10
    theta: float = 0.5
    u: tuple[float, float] = (0.1, 0.0)
    k: float = 0.0                 # diffusion coefficient (mode 6: 1.0)
    diffusion: bool = False
    implicit: bool = False
    direct_solver: bool = False
    # Rannacher startup: take the first two implicit steps with theta=1
    # before switching to the configured theta.  Crank-Nicolson (theta=0.5)
    # is not L-stable, so an initial-data/BC discontinuity rings forever at
    # the boundary without it.
    rannacher: bool = True
    dtype: str = "float32"

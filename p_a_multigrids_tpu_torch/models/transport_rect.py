"""Structured rectangular DG advection (mode 1), from the JAX package's
``models/transport_rect.py``.

Bilinear-quad DG with upwind face fluxes and a mass solve each
nonlinearity iteration, on the moving-box problem.  The geometry is static
and built once on the host (numpy); one time step is a few batched einsums
and gathers in plain PyTorch on the tables' device (on the TPU it was XLA,
not a Pallas kernel).  The mass solve is the exact 4x4 inverse
(``direct_solver``) or element Jacobi sweeps preconditioned by the lumped
mass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import RectConfig
from ..mesh import geometry, structured
from ..ops import local_matrices as lm
from ..utils import shape_functions
from ..validation import analytical as va

# my face f's two nodes match the neighbor's nodes NEIGH_PERM[f] (same
# physical corners; faces are 0=bottom, 1=right, 2=top, 3=left)
NEIGH_PERM = np.asarray([[2, 3], [0, 2], [1, 0], [3, 1]], np.int32)
OPP_FACE = np.asarray([2, 3, 0, 1], np.int32)

# the tables build_problem makes, in the run dtype (index tables int64)
TABLE_KEYS = ("n", "nx", "detwei", "face_sn", "sn1d", "sdet", "snorm",
              "mass", "minv", "ml", "face_ele", "neigh_perm", "u")


@dataclasses.dataclass
class RectProblem:
    cfg: RectConfig
    x_all: np.ndarray          # (E, 2, 4)
    face_ele: np.ndarray       # (E, 4)
    tables: dict               # tensors on the run's device


def host_tables(cfg: RectConfig):
    """(x_all, face_ele, tables): the mesh and every table of the step as
    numpy arrays (float64 geometry; the run dtype is applied by
    ``tables_on``)."""
    dx = cfg.x_length / cfg.no_ele_row
    dy = cfg.y_length / cfg.no_ele_col
    x_all, face_ele = structured.rect_mesh(cfg.no_ele_row, cfg.no_ele_col,
                                           dx, dy)
    n, nlx, w, ft = shape_functions.quad_bilinear(2)
    detwei, nx, _ = geometry.quad_det_nlx(x_all, nlx, w)

    E = x_all.shape[0]
    fn = ft["face_nodes"]
    sngi = 2
    sn1d, snlx1d, sw1d = shape_functions.edge_p1(sngi)
    centroid = x_all.mean(axis=2)
    sdet = np.zeros((E, 4, sngi))
    snorm = np.zeros((E, 4, sngi, 2))
    for f in range(4):
        a, b = fn[f]
        xsl = x_all[:, :, [a, b]]
        approx = xsl.mean(axis=2) - centroid
        sdet[:, f], snorm[:, f] = geometry.det_snlx(xsl, snlx1d, sw1d,
                                                    approx)
    mass = lm.mass(n, detwei)
    tables = dict(n=n, nx=nx, detwei=detwei, face_sn=ft["face_sn"],
                  sn1d=sn1d, sdet=sdet, snorm=snorm, mass=mass,
                  minv=np.linalg.inv(mass), ml=lm.lumped_mass(n, detwei),
                  face_ele=face_ele, neigh_perm=NEIGH_PERM,
                  u=np.asarray(cfg.u))
    return x_all, face_ele, tables


def tables_on(tables: dict, dtype: str, device) -> dict:
    """Host tables -> tensors on ``device``: floats in ``dtype``, index
    tables int64."""
    out = {}
    for key in TABLE_KEYS:
        a = np.asarray(tables[key])
        a = a.astype(np.int64) if a.dtype.kind in "iu" else a.astype(dtype)
        out[key] = torch.as_tensor(np.ascontiguousarray(a), device=device)
    return out


def build_problem(cfg: RectConfig, device="cuda") -> RectProblem:
    """The mesh and the step's tables on ``device`` (the card unless the
    caller asks for the CPU)."""
    x_all, face_ele, tables = host_tables(cfg)
    return RectProblem(cfg=cfg, x_all=x_all, face_ele=face_ele,
                       tables=tables_on(tables, cfg.dtype, device))


def _rhs(tb: dict, T: torch.Tensor) -> torch.Tensor:
    """Volume advection + upwind face flux residual (E, 4)."""
    ein = torch.einsum
    u = tb["u"]
    # the velocity is constant, t at the volume quadrature points:
    t_gi = ein("gi,ei->eg", tb["n"], T)
    rhs = ein("egdi,d,eg,eg->ei", tb["nx"], u, t_gi, tb["detwei"])

    # the neighbor's values at my face nodes; zero inflow on the boundary
    E = T.shape[0]
    face_ele = tb["face_ele"]
    Tn = T[face_ele.clamp(min=0)]                        # (E, 4, 4 nodes)
    T2 = torch.gather(Tn, -1, tb["neigh_perm"][None].expand(E, 4, 2))
    T2 = torch.where((face_ele >= 0)[..., None], T2, torch.zeros_like(T2))

    t_sgi = ein("fgi,ei->efg", tb["face_sn"], T)
    t2_sgi = ein("gk,efk->efg", tb["sn1d"], T2)
    un = ein("efgd,d->efg", tb["snorm"], u)
    income = 0.5 + 0.5 * torch.sign(-un)
    s_cont = un * tb["sdet"] * ((1.0 - income) * t_sgi + income * t2_sgi)
    return rhs - ein("fgi,efg->ei", tb["face_sn"], s_cont)


def make_step(problem: RectProblem):
    """(step, dt): one time step T -> T of ``nits`` nonlinearity
    iterations, each a mass solve of M T = M told + dt rhs(T)."""
    cfg = problem.cfg
    tb = problem.tables
    dx = cfg.x_length / cfg.no_ele_row
    dt = cfg.cfl * dx

    def mul(A, x):
        return torch.einsum("eij,ej->ei", A, x)

    def step(T):
        mass_told = mul(tb["mass"], T)
        for _ in range(cfg.nits):
            b = mass_told + dt * _rhs(tb, T)
            if cfg.direct_solver:
                T = mul(tb["minv"], b)
            else:                                        # element Jacobi
                x = T
                for _ in range(cfg.njac_its):
                    x = x + (b - mul(tb["mass"], x)) / tb["ml"]
                T = x
        return T

    return step, dt


def initial_condition(problem: RectProblem) -> torch.Tensor:
    """The 1-D box: elements no_ele_row//5 - 1 to no_ele_row//2 - 1 by flat
    index (the bottom row of cells when no_ele_col > 1) are 1."""
    cfg = problem.cfg
    E = problem.x_all.shape[0]
    T0 = np.zeros((E, 4))
    T0[cfg.no_ele_row // 5 - 1:cfg.no_ele_row // 2, :] = 1.0
    return torch.as_tensor(T0, dtype=problem.tables["n"].dtype,
                           device=problem.tables["n"].device)


def solve(cfg: RectConfig | None = None, device="cuda", ntime=None):
    """Run the moving-box problem for int(time / dt) steps (or ``ntime``) on
    ``device`` (the card unless the caller asks for the CPU); returns
    (problem, T, dt, nsteps)."""
    cfg = cfg or RectConfig()
    problem = build_problem(cfg, device)
    step, dt = make_step(problem)
    nsteps = int(cfg.time / dt) if ntime is None else ntime
    T = initial_condition(problem)
    for _ in range(nsteps):
        T = step(T)
    return problem, T, dt, nsteps


def analytical_comparison(problem: RectProblem, dt: float, ntime: int):
    """Translated-box reference values at the element nodes."""
    cfg = problem.cfg
    dx = cfg.x_length / cfg.no_ele_row
    x0 = (cfg.no_ele_row // 5 - 1) * dx
    x1 = (cfg.no_ele_row // 2) * dx
    xs = problem.x_all[:, 0, :]
    return va.moving_box(xs, dt * ntime, cfg.u[0], x0, x1, cfg.x_length)

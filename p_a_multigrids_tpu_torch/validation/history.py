"""Residual-history parity harness (port of the JAX package's
``validation/history.py``).

Records per-V-cycle residual Linf histories (the reference's
``get_convergence``) of the reference-ACTIVE mode-9 configuration (damped
Jacobi omega = 0.8, the corner-average restrictor, surface terms off, the
manufactured sin(x+y) problem), of the PRODUCTION configuration (full SIP,
Chebyshev, the strength-filtered SA correction of the finest level) and of
the CLI's mode-9 configuration, through this package's one cycle,
``SemiSolver._vcycle_t``.

The JAX package pins its histories on reference meshes (``HISTORY.json``)
that are not in this repository, so the port pins its own on generated
stand-ins for the JAX package's ``DEFAULT_SPECS`` (``STAND_INS``).  The
pins, ``history_pins.json`` beside this module, are written by
``scripts/torch_record_history.py``, which runs the JAX package on the CPU
in float64 with ``pallas_phase=False``, as its ``record_zoo`` does, and
stores with each spec its ``num_macro``, ``x_hash`` (``mesh_hash``: scipy's
Delaunay may mesh a ``.geo`` domain differently on another installation,
and a history is only comparable on the same mesh) and two floors:
``f64_floor``, the smallest value of the float64 history over 25 cycles,
and ``f32_floor``, the largest distance between a float32 and a float64
evaluation of b - A x at the same float64 iterates of the pin's cycles (the
rounding of the residual's evaluation alone).  ``hold`` compares a history
with a pin within a relative tolerance plus twice the floor of its
precision.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from ..config import Physics, SemiConfig, Solver

# the .geo stand-ins: a unit square of 98 macros (for the reference's
# 96-macro 2_split.msh) and an annulus of 2,048 macros (393,216 DOF at
# n_split 3), the CLI's .geo domain at full width.  The annulus's circles
# are cut into arcs of 45 and 90 degrees, whose 16 samples each lie closer
# than lc, so that no boundary point is added on a straight chord: two
# semicircles resampled to lc put collinear points on the hull, where the
# Delaunay step makes zero-area triangles (a singular operator).
SQUARE_GEO = """
lc = 0.155;
Point(1) = {0, 0, 0, lc};
Point(2) = {1, 0, 0, lc};
Point(3) = {1, 1, 0, lc};
Point(4) = {0, 1, 0, lc};
Line(1) = {1, 2};
Line(2) = {2, 3};
Line(3) = {3, 4};
Line(4) = {4, 1};
Line Loop(5) = {1, 2, 3, 4};
Plane Surface(6) = {5};
"""

ANNULUS_GEO = """
lc = 0.055;
Point(1) = {0, 0, 0, lc};
Point(2) = {1, 0, 0, lc};
Point(3) = {cos(pi/4), sin(pi/4), 0, lc};
Point(4) = {0, 1, 0, lc};
Point(5) = {-cos(pi/4), sin(pi/4), 0, lc};
Point(6) = {-1, 0, 0, lc};
Point(7) = {-cos(pi/4), -sin(pi/4), 0, lc};
Point(8) = {0, -1, 0, lc};
Point(9) = {cos(pi/4), -sin(pi/4), 0, lc};
Point(10) = {0.4, 0, 0, lc};
Point(11) = {0, 0.4, 0, lc};
Point(12) = {-0.4, 0, 0, lc};
Point(13) = {0, -0.4, 0, lc};
Circle(1) = {2, 1, 3};
Circle(2) = {3, 1, 4};
Circle(3) = {4, 1, 5};
Circle(4) = {5, 1, 6};
Circle(5) = {6, 1, 7};
Circle(6) = {7, 1, 8};
Circle(7) = {8, 1, 9};
Circle(8) = {9, 1, 2};
Circle(9) = {10, 1, 11};
Circle(10) = {11, 1, 12};
Circle(11) = {12, 1, 13};
Circle(12) = {13, 1, 10};
Line Loop(30) = {1, 2, 3, 4, 5, 6, 7, 8};
Line Loop(31) = {9, 10, 11, 12};
Plane Surface(40) = {30, 31};
"""

# name -> (what it stands in for, how it is made)
STAND_INS = {
    "tri_sn2": ("test_sn2.msh (12 macros)",
                ("tri_mesh", (2, 3, 1 / 2, 1 / 3))),
    "square_geo": ("2_split.msh (96 macros)", ("mesh_geo", SQUARE_GEO)),
    "bench": ("untitled8192.msh (8,192 macros; 393,216 DOF at n_split 2)",
              ("tri_mesh", (128, 32, 3 / 128, 1 / 128))),
    "annulus_geo": ("the CLI's .geo domain (2,048 macros)",
                    ("mesh_geo", ANNULUS_GEO)),
}

# the JAX package's DEFAULT_SPECS on the stand-ins, and the annulus under
# the CLI's configuration ("cli": CLI_KW at the CLI's defaults, the mesh as
# the CLI loads it, not reordered).  The CPU tests leave out LARGE_SPECS.
DEFAULT_SPECS = [
    ("tri_sn2", 3, 1), ("tri_sn2", 3, 2), ("tri_sn2", 3, 4),
    ("square_geo", 4, 1), ("square_geo", 4, 2), ("square_geo", 4, 4),
    ("bench", 2, 1), ("bench", 2, 2),
    ("tri_sn2", 3, "amg"), ("square_geo", 4, "amg"),
    ("annulus_geo", 3, "cli"),
]
LARGE_SPECS = [("bench", 2, 1), ("bench", 2, 2), ("annulus_geo", 3, "cli")]

# the SemiConfig fields the mode-9 CLI sets at its defaults with --krylov
# (both packages' CLIs): levels 2, two steps of PCG to 1e-8
CLI_KW = dict(multi_levels=2, ntime=2, dt=1.25e-5, theta=1.0, n_multigrid=2,
              n_smooth=4, omega=0.8, cheb_degree=6, cheb_lower=0.1,
              cycle_type="v", restrictor="linear", krylov=True,
              krylov_tol=1e-8, amg=False, agg_strength=0.4, coarse_pack=1)
CLI_ARGS = ["--mode", "9", "--krylov"]


def reference_active_config(n_split: int, levels: int,
                            dt: float = 1.25e-5, **kw) -> SemiConfig:
    """The reference's active mode-9 numerical configuration: solver 3
    (point relaxation), omega 0.8, n_smooth 4, the corner-average
    restrictor, the volume-diffusion-only operator (surface flux loop
    commented out), dt = CFL*dx of the mode-9 call."""
    phys = Physics(diffusion=True, advection=False, surface_terms=False)
    return SemiConfig(n_split=n_split, multi_levels=levels, dt=dt,
                      ntime=1, n_multigrid=1, solver=Solver.JACOBI,
                      omega=0.8, n_smooth=4, restrictor="corner_average",
                      physics=phys, manufactured=True, **kw)


def production_config(n_split: int, **kw) -> SemiConfig:
    """The PRODUCTION numerical configuration: full SIP physics, Chebyshev
    block-Jacobi smoothing, strength-filtered smoothed-aggregation
    correction of the finest level."""
    return SemiConfig(n_split=n_split, multi_levels=1, dt=1e8, ntime=1,
                      n_multigrid=1, amg=True, agg_strength=0.4,
                      manufactured=True, **kw)


def cli_config(n_split: int, **kw) -> SemiConfig:
    """The mode-9 CLI's configuration with --krylov at its defaults."""
    return SemiConfig(n_split=n_split, **CLI_KW, **kw)


def spec_config(n_split: int, levels, **kw) -> SemiConfig:
    """The configuration of a spec's ``levels`` ("amg", "cli" or a level
    count)."""
    if levels == "amg":
        return production_config(n_split, **kw)
    if levels == "cli":
        return cli_config(n_split, **kw)
    return reference_active_config(n_split, levels, **kw)


def spec_key(name: str, n_split: int, levels) -> str:
    suffix = levels if levels in ("amg", "cli") else f"l{levels}"
    return f"{name}:s{n_split}:{suffix}"


def stand_in(name: str, structured=None, geo=None, topology=None,
             reorder: bool = True):
    """The stand-in mesh ``name``, made with the given mesh modules (this
    package's by default; the recording script passes the JAX package's)
    and RCM-reordered as the JAX package's ``record_zoo`` reorders its
    meshes (``reorder=False``: as the CLI loads it)."""
    if structured is None:
        from ..mesh import geo, structured, topology
    how, arg = STAND_INS[name][1]
    mesh = (structured.tri_mesh(*arg) if how == "tri_mesh"
            else geo.mesh_geo(arg))
    return topology.rcm_reorder(mesh) if reorder else mesh


def spec_mesh(name: str, levels, **modules):
    """A spec's mesh: the "cli" spec's as the CLI loads it, the others'
    RCM-reordered."""
    return stand_in(name, reorder=levels != "cli", **modules)


def mesh_hash(mesh) -> str:
    """A hash of the mesh's vertex coordinates X (float64)."""
    X = np.ascontiguousarray(np.asarray(mesh.X, np.float64))
    return hashlib.sha256(X.tobytes()).hexdigest()[:16]


def residual_history(solver, ncycles: int = 12) -> list[float]:
    """max|b - A x| after each of ``ncycles`` V-cycles from the initial
    condition, b its right-hand side."""
    from ..ops.fused import to_t

    x_t = to_t(solver.initial_condition())
    b_t = solver._rhs_t(x_t)
    out = []
    for _ in range(ncycles):
        x_t = solver._vcycle_t(0, x_t, b_t)
        r_t = b_t - solver._apply_t(0, x_t, True)
        out.append(float(r_t.abs().max()))
    return out


def contraction(norms) -> float:
    """The mean contraction factor rho of a history, as the JAX package
    computes it (the first two cycles skipped when there are more than
    three, zeros dropped)."""
    norms = np.asarray(norms, np.float64)
    pos = norms[norms > 0]
    skip = min(2, len(pos) - 2) if len(pos) > 3 else 0
    return float((pos[-1] / pos[skip])
                 ** (1.0 / max(len(pos) - 1 - skip, 1)))


def record_history(mesh, cfg: SemiConfig, ncycles: int = 12) -> dict:
    """Run ncycles V-cycles on the CPU; return the residual Linf per cycle
    + rho."""
    from ..models import semi as msemi

    solver = msemi.SemiSolver(msemi.build_problem(mesh, cfg), "cpu")
    norms = residual_history(solver, ncycles)
    return {"residual_linf": norms, "rho": contraction(norms)}


def record_zoo(mesh_specs, ncycles: int = 12) -> dict:
    """Histories over (stand-in, n_split, levels) specs in float64 ->
    JSON dict, keyed as ``spec_key``."""
    out = {}
    for name, n_split, levels in mesh_specs:
        mesh = spec_mesh(name, levels)
        cfg = spec_config(n_split, levels, dtype="float64")
        key = spec_key(name, n_split, levels)
        out[key] = record_history(mesh, cfg, ncycles)
        out[key]["num_macro"] = mesh.num_elements
        out[key]["x_hash"] = mesh_hash(mesh)
    return out


def load_committed(path: str | None = None) -> dict:
    """The JAX package's committed histories (``HISTORY.json`` at the root
    of the repository, recorded on reference meshes), or those of
    ``path``."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "HISTORY.json")
    with open(path) as f:
        return json.load(f)


def pins_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "history_pins.json")


def load_pins(path: str | None = None) -> dict:
    """The committed pins (``history_pins.json``)."""
    with open(path or pins_path()) as f:
        return json.load(f)


# a float64 history against its pin, on the card as on the CPU: the same
# float64 iteration in another summation order, so within 1e-8 of each
# cycle plus twice the pin's f64_floor (hold(..., rel=F64_REL,
# floor="f64_floor"))
F64_REL = 1e-8


def hold(got, pin: dict, rel: float = 0.02, floor: str = "f32_floor"
         ) -> list[str]:
    """A history against a float64 pin: each cycle within ``rel`` of the
    pin plus twice the pin's ``floor``: one floor for the rounding of this
    history's evaluation of the residual, one for its iterate, which
    stagnates where a residual below the floor cannot be resolved.  Where
    twice the floor exceeds the pin, a cycle is held only to that band.
    Returns the failures (empty when it holds)."""
    want, fl = pin["residual_linf"], 2.0 * pin[floor]
    if len(got) != len(want):
        return [f"{len(got)} cycles, the pin has {len(want)}"]
    return [f"cycle {i + 1}: {g:.4e} not within {rel:.0e} + {fl:.2e} of "
            f"{w:.4e}" for i, (g, w) in enumerate(zip(got, want))
            if not (np.isfinite(g) and abs(g - w) <= rel * w + fl)]

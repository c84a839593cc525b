"""Record the targets of the port's bench on the card,
p_a_multigrids_tpu_torch/validation/bench_pins.json.

    PYTHONPATH=. python scripts/torch_record_bench.py [SECTION ...]

Runs the JAX system's own ``bench.py`` functions (``_solver_for``,
``_vcycle_stats`` with a small ``n_time``, ``_rho_linear`` and
``_pcg_chain``, a closure of its ``main`` that ``load_jax_bench`` compiles
on its own) on the CPU, in float32, on the port's stand-in meshes
(``p_a_multigrids_tpu_torch.bench.BENCH_MESH`` at n_split 2, 393,216 DOF;
``utils.profiling.SWEEP_MESH`` at n_split 5, 294,912 DOF) with the port's
bench configurations.  Each rho is stored with its ``floor``, the distance
between the float32 value and the same computation in float64: how far
float32 rounding alone moves it.  A history rho is the port's
``bench._rho_from_history`` of the JAX history (``rho_bench_py`` keeps
``bench.py``'s own guard beside it).  SECTIONs (geometric, amg, gate,
level_sweep) record only those and keep the rest of the file.  About 16
minutes on 8 CPU cores, most of it the level sweep.
"""

import ast
import importlib.util
import json
import pathlib
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from p_a_multigrids_tpu.config import SemiConfig  # noqa: E402
from p_a_multigrids_tpu.mesh import structured  # noqa: E402
from p_a_multigrids_tpu.models import semi as msemi  # noqa: E402

from p_a_multigrids_tpu_torch import bench  # noqa: E402
from p_a_multigrids_tpu_torch.utils import profiling  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PINS = REPO / "p_a_multigrids_tpu_torch" / "validation" / "bench_pins.json"
# the level sweep's rows as utils.profiling.sweep_solver and
# deep_amg_solver build them
SWEEP = dict(dt=1e8, n_split=5, cheb_degree=6, cycle_type="w")
DEEP_AMG = dict(dt=1e8, n_split=5, multi_levels=1, amg=True,
                agg_strength=0.5, cheb_degree=16, cheb_lower=0.05)
N_TIME = 1


def load_jax_bench():
    """The root ``bench.py`` as a module, with its ``_pcg_chain`` (defined
    inside ``main``) compiled on its own beside the imports ``main`` makes
    for it."""
    path = REPO / "bench.py"
    spec = importlib.util.spec_from_file_location("jax_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    main = next(n for n in ast.parse(path.read_text()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = [n for n in ast.walk(main)
            if isinstance(n, (ast.Import, ast.ImportFrom))
            or (isinstance(n, ast.FunctionDef) and n.name == "_pcg_chain")]
    exec(compile(ast.Module(body, []), str(path), "exec"), vars(mod))
    return mod


def jax_solver(jb, mesh, dtype: str, dt: float, **kw):
    """bench.py's ``_solver_for`` in float32; the same configuration built
    directly in float64 (``_solver_for`` fixes float32)."""
    if dtype == "float32":
        return jb._solver_for(mesh, dt=dt, **kw)
    return msemi.SemiSolver(msemi.build_problem(mesh, SemiConfig(
        dt=dt, ntime=1, n_multigrid=1, dtype=dtype, **kw)))


def history_pin(jb, mesh, n_rho=10, **kw) -> dict:
    """rho of the residual history in float32 and float64, and the float32
    history."""
    out = {}
    for dtype in ("float32", "float64"):
        s = jax_solver(jb, mesh, dtype, **kw)
        _, rho_jax, norms = jb._vcycle_stats(s, n_rho=n_rho, n_time=N_TIME)
        out[dtype] = (bench._rho_from_history(norms), rho_jax,
                      [float(v) for v in norms])
    r32, r64 = out["float32"][0], out["float64"][0]
    return {"rho": r32, "floor": abs(r32 - r64), "rho_f64": r64,
            "rho_bench_py": out["float32"][1],
            "residual_history": out["float32"][2]}


def record_geometric(jb) -> dict:
    mesh = structured.tri_mesh(*bench.BENCH_MESH)
    return history_pin(jb, mesh, **bench.GEOMETRIC)


def record_amg(jb) -> dict:
    mesh = structured.tri_mesh(*bench.BENCH_MESH)
    pin = {"history": history_pin(jb, mesh, **bench.AMG)}
    rho = {}
    for dtype in ("float32", "float64"):
        s = jax_solver(jb, mesh, dtype, **bench.AMG)
        rho[dtype] = jb._rho_linear(s)
        if dtype == "float32":
            pin["pcg_its_to_1e6"] = jb._pcg_chain(s)[0]
    pin.update(rho=rho["float32"], floor=abs(rho["float32"] - rho["float64"]),
               rho_f64=rho["float64"])
    s = jb._solver_for(mesh, agg_sweeps=1, **bench.AMG)
    pin["v11"] = {"pcg_its_to_1e6": jb._pcg_chain(s)[0]}
    return pin


def record_gate(jb) -> dict:
    mesh = structured.tri_mesh(*bench.BENCH_MESH)
    out = {}
    for dtype in ("float32", "float64"):
        s = jax_solver(jb, mesh, dtype, **bench.GATE)
        out[dtype] = float(np.asarray(s.error(s.run())).mean())
    return {"l1_err": out["float32"], "l1_err_f64": out["float64"]}


def record_level_sweep(jb) -> dict:
    mesh = structured.tri_mesh(*profiling.SWEEP_MESH)
    rows = {}
    for lv in (1, 2, 3, 4, 5, 6):
        t0 = time.time()
        rows[str(lv)] = history_pin(jb, mesh, multi_levels=lv, **SWEEP)
        print(f"level {lv}: rho {rows[str(lv)]['rho']:.4f} "
              f"({time.time() - t0:.0f} s)", file=sys.stderr, flush=True)
    rows["production_amg_deg16"] = history_pin(jb, mesh, **DEEP_AMG)
    return rows


SECTIONS = {"geometric": record_geometric, "amg": record_amg,
            "gate": record_gate, "level_sweep": record_level_sweep}


def main(argv=None):
    names = (argv if argv is not None else sys.argv[1:]) or list(SECTIONS)
    pins = json.loads(PINS.read_text()) if PINS.exists() else {}
    pins["source"] = (
        "scripts/torch_record_bench.py: the root bench.py's functions, JAX "
        f"on the CPU in float32 (floor: float64), BENCH_MESH "
        f"{bench.BENCH_MESH}, SWEEP_MESH {profiling.SWEEP_MESH}")
    jb = load_jax_bench()
    for name in names:
        t0 = time.time()
        pins[name] = SECTIONS[name](jb)
        print(f"{name}: {time.time() - t0:.0f} s", file=sys.stderr,
              flush=True)
        PINS.write_text(json.dumps(pins, indent=1) + "\n")


if __name__ == "__main__":
    main()

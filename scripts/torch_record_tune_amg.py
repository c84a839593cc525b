"""Record the targets of the port's knob sweep on the card,
p_a_multigrids_tpu_torch/validation/tune_amg_pins.json.

    PYTHONPATH=. python scripts/torch_record_tune_amg.py [SECTION ...]

Runs the JAX system's own ``scripts/tune_amg.py``: its ``cases``, the
``SemiConfig`` fields its loop gives every case, and the closures of its
``main`` (``rho_linear``, ``pcg_ms``), compiled on their own by
``load_tune_amg``, on the JAX package on the CPU, in float32, on the
port's stand-in mesh (``p_a_multigrids_tpu_torch.bench.BENCH_MESH`` after
``rcm_reorder``, 393,216 DOF at n_split 2).  Each rho is stored with its
``floor``, the distance between the float32 value and the same computation
in float64: how far float32 rounding alone moves it.  ``rho_linear`` draws
its start vector in float32 whatever the solver's dtype, and a float32
carry does not enter the scan of a float64 cycle, so the float64 run casts
that float32 draw to float64 (``load_tune_amg(draw_dtype)``).  No time is
pinned.  SECTIONs: ``cases`` (the pins; 588 s on 8 CPU cores, 66-99 s a
case) and ``cross_check`` (the first case, the root ``bench.py``'s amg
configuration, on the bench's mesh without the reordering, as
``validation/bench_pins.json`` has it); without one, both, and the rest of
the file is kept.
"""

import ast
import json
import pathlib
import sys
import time
import types

import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from p_a_multigrids_tpu.config import SemiConfig  # noqa: E402
from p_a_multigrids_tpu.mesh import structured, topology  # noqa: E402
from p_a_multigrids_tpu.models import semi as msemi  # noqa: E402

from p_a_multigrids_tpu_torch import bench  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "tune_amg.py"
PINS = (REPO / "p_a_multigrids_tpu_torch" / "validation"
        / "tune_amg_pins.json")


class _CastDraw:
    """jax.numpy with an ``asarray`` that casts to ``dtype``."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __getattr__(self, name):
        return getattr(jnp, name)

    def asarray(self, a, dtype=None):
        return jnp.asarray(a, dtype or self.dtype)


def _main_node(tree):
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def script_base(tree=None) -> dict:
    """The literal keywords of the ``SemiConfig(...)`` call in the
    script's case loop (every field but the case's own knobs)."""
    tree = tree or ast.parse(SCRIPT.read_text())
    call = next(n for n in ast.walk(_main_node(tree))
                if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "SemiConfig")
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg is not None}


def load_tune_amg(draw_dtype=None):
    """``scripts/tune_amg.py`` as a module: its imports, the closures
    defined in its ``main`` and its ``cases`` list, compiled on their own,
    with ``base`` (``script_base``).  With ``draw_dtype``, the closures'
    ``jnp.asarray`` casts to it."""
    tree = ast.parse(SCRIPT.read_text())
    body = [n for n in tree.body if isinstance(n, (ast.Import,
                                                     ast.ImportFrom))]
    body += [n for n in _main_node(tree).body
             if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))
             or (isinstance(n, ast.Assign)
                 and [getattr(t, "id", None) for t in n.targets]
                 == ["cases"])]
    mod = types.ModuleType("jax_tune_amg")
    mod.__file__ = str(SCRIPT)
    exec(compile(ast.Module(body, []), str(SCRIPT), "exec"), vars(mod))
    mod.base = script_base(tree)
    if draw_dtype is not None:
        mod.jnp = _CastDraw(draw_dtype)
    return mod


def jax_solver(ts, mesh, knobs: dict, dtype: str):
    """A case's JAX SemiSolver as the script's loop builds it, in
    ``dtype``."""
    cfg = SemiConfig(**{**ts.base, "dtype": dtype}, **knobs)
    return msemi.SemiSolver(msemi.build_problem(mesh, cfg))


def record_case(ts32, ts64, mesh, knobs: dict) -> dict:
    """rho in float32 with its float64 floor, and PCG iterations to 1e-6
    in float32."""
    s = jax_solver(ts32, mesh, knobs, "float32")
    rho32 = ts32.rho_linear(s)
    its = ts32.pcg_ms(s)[0]
    del s
    rho64 = ts64.rho_linear(jax_solver(ts64, mesh, knobs, "float64"))
    return {"rho": rho32, "floor": abs(rho32 - rho64), "rho_f64": rho64,
            "pcg_its_to_1e6": its}


def record_cases(ts32, ts64) -> dict:
    mesh = topology.rcm_reorder(structured.tri_mesh(*bench.BENCH_MESH))
    out = {}
    for name, knobs in ts32.cases:
        t0 = time.time()
        out[name] = record_case(ts32, ts64, mesh, knobs)
        print(f"{name}: {out[name]} ({time.time() - t0:.0f} s)",
              file=sys.stderr, flush=True)
    return out


def record_cross_check(ts32, ts64) -> dict:
    """The first case, the root bench.py's amg configuration, on the
    bench's own mesh (not reordered), in float32: what
    validation/bench_pins.json's amg rho was recorded on."""
    name, knobs = ts32.cases[0]
    s = jax_solver(ts32, structured.tri_mesh(*bench.BENCH_MESH), knobs,
                   "float32")
    return {"case": name, "mesh": f"tri_mesh{bench.BENCH_MESH}",
            "rho": ts32.rho_linear(s)}


SECTIONS = {"cases": record_cases, "cross_check": record_cross_check}


def main(argv=None):
    names = (argv if argv is not None else sys.argv[1:]) or list(SECTIONS)
    pins = json.loads(PINS.read_text()) if PINS.exists() else {}
    pins["source"] = (
        "scripts/torch_record_tune_amg.py: scripts/tune_amg.py's cases, "
        "rho_linear and pcg_ms, JAX on the CPU in float32 (floor: "
        f"float64), rcm_reorder(tri_mesh{bench.BENCH_MESH}), n_split 2")
    ts32, ts64 = load_tune_amg(), load_tune_amg(jnp.float64)
    for name in names:
        t0 = time.time()
        pins[name] = SECTIONS[name](ts32, ts64)
        print(f"{name}: {time.time() - t0:.0f} s", file=sys.stderr,
              flush=True)
        PINS.write_text(json.dumps(pins, indent=1) + "\n")


if __name__ == "__main__":
    main()

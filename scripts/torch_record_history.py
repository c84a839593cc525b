"""Record the port's residual-history pins,
p_a_multigrids_tpu_torch/validation/history_pins.json.

    PYTHONPATH=. python scripts/torch_record_history.py [KEY ...]

Runs the JAX package (the reference) on the CPU in float64 with
``pallas_phase=False``, as its ``validation.history.record_zoo`` does, over
the port's stand-in specs (``p_a_multigrids_tpu_torch.validation.history.
DEFAULT_SPECS``), on meshes that the JAX package's own mesh modules make,
over 25 cycles in float64 for its ``f64_floor``, and stores with each the
float32 evaluation floor of its residual (``f32_floor``), the mesh's
``num_macro`` and its ``x_hash``.  With KEYs
(``spec_key`` names) only those specs are recorded again and the rest of
the file is kept.  This script is the one place outside the tests where the
JAX package and the port meet: the port reads the pins without JAX.  The
two specs on 393,216-DOF meshes take a few minutes.
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from p_a_multigrids_tpu.config import SemiConfig  # noqa: E402
from p_a_multigrids_tpu.mesh import geo, structured, topology  # noqa: E402
from p_a_multigrids_tpu.validation import history as jhist  # noqa: E402

from p_a_multigrids_tpu_torch.validation import history  # noqa: E402

# cycles of the float64 floor run (the pins keep the first PIN_CYCLES)
FLOOR_CYCLES = 25
PIN_CYCLES = 12


def jax_config(n_split: int, levels, dtype: str):
    """The JAX package's configuration of a spec, as record_zoo builds
    it."""
    kw = dict(dtype=dtype, pallas_phase=False)
    if levels == "amg":
        return jhist.production_config(n_split, **kw)
    if levels == "cli":
        return SemiConfig(n_split=n_split, **history.CLI_KW, **kw)
    return jhist.reference_active_config(n_split, levels, **kw)


def f32_floor(mesh, n_split: int, levels, ncycles: int) -> float:
    """The float32 evaluation floor of a spec's residual: the largest
    distance, over the pin's cycles, between one float32 and one float64
    evaluation of b - A x at the same float64 iterate x (the float64
    V-cycles' own), max |fl32(b - A x) - (b - A x)|.  This is the rounding
    of the residual's evaluation alone; a float32 history cannot resolve a
    residual below it."""
    import jax.numpy as jnp

    from p_a_multigrids_tpu.models import semi as msemi

    s64, s32 = (msemi.SemiSolver(msemi.build_problem(
        mesh, jax_config(n_split, levels, dt))) for dt in ("float64",
                                                           "float32"))
    b64 = s64._rhs(s64.initial_condition())
    b32 = s32._rhs(s32.initial_condition())
    cycle = jax.jit(lambda x: s64._vcycle(0, x, b64))
    gap = jax.jit(lambda x: jnp.max(jnp.abs(
        s32.residual(0, x.astype(jnp.float32), b32, True)
        .astype(jnp.float64) - s64.residual(0, x, b64, True))))
    x, worst = s64.initial_condition(), 0.0
    for _ in range(ncycles):
        x = cycle(x)
        worst = max(worst, float(gap(x)))
    return worst


def record(name: str, n_split: int, levels) -> dict:
    """A spec's pin: the float64 history of its first PIN_CYCLES cycles and
    its rho, the float64 floor (the smallest value of FLOOR_CYCLES cycles:
    where a history stops falling, it sits on its floor) and the float32
    evaluation floor (``f32_floor``)."""
    mesh = history.spec_mesh(name, levels, structured=structured, geo=geo,
                             topology=topology)
    h64 = jhist.record_history(mesh, jax_config(n_split, levels, "float64"),
                               ncycles=FLOOR_CYCLES)["residual_linf"]
    rec = {"residual_linf": h64[:PIN_CYCLES],
           "rho": history.contraction(h64[:PIN_CYCLES]),
           "f64_floor": float(min(h64)),
           "f32_floor": f32_floor(mesh, n_split, levels, PIN_CYCLES)}
    rec["num_macro"] = mesh.num_elements
    rec["x_hash"] = history.mesh_hash(mesh)
    rec["stand_in_for"] = history.STAND_INS[name][0]
    return rec


def main(keys):
    path = history.pins_path()
    out = history.load_pins(path) if keys and os.path.exists(path) else {}
    for spec in history.DEFAULT_SPECS:
        key = history.spec_key(*spec)
        if keys and key not in keys:
            continue
        t0 = time.time()
        out[key] = record(*spec)
        v = out[key]
        print(f"{key}: {v['num_macro']} macros, rho={v['rho']:.4f} "
              f"first={v['residual_linf'][0]:.3e} "
              f"last={v['residual_linf'][-1]:.3e} "
              f"f64_floor={v['f64_floor']:.3e} f32_floor={v['f32_floor']:.3e} "
              f"({time.time() - t0:.1f} s)",
              flush=True)
    order = [history.spec_key(*s) for s in history.DEFAULT_SPECS]
    with open(path, "w") as f:
        json.dump({k: out[k] for k in order if k in out}, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(sys.argv[1:])

"""The JAX package's distributed amg against its serial solver, cycle by
cycle, float32 on 4 virtual CPU devices: how far the sharded SA
restriction's summation order moves the residual history.

    PYTHONPATH=. python scripts/torch_dist_amg_witness.py [ROWS COLS]

The configuration is ``chip_smoke.py``'s ``DIST_CONFIGS["amg"]`` (the
production amg one: n_split 2, 1 level, amg, agg_strength 0.5, degree-16
Chebyshev from 0.05, dt 0.05) on its stand-in ``tri_mesh(128, 32, 3/128,
1/128)`` (393,216 DOF); ROWS COLS cut the mesh (``tri_mesh(ROWS, COLS,
3/ROWS, 1/ROWS)``) for a quick check.  From the initial condition both
solvers run 10 V-cycles on the same right-hand side: the distributed one
through ``DistributedStencilSolver._vcycle`` inside shard_map, the serial
twin (``solver.serial``, the same reordered mesh) through
``_vcycle_t``.  After each cycle max|b - A x| of each iterate is evaluated
by the serial twin's operator, so the two histories differ only by their
iterates.  Prints one JSON line: both histories, the relative distance of
each cycle, and the largest relative distance of the two iterates.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import json  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from p_a_multigrids_tpu.config import SemiConfig  # noqa: E402
from p_a_multigrids_tpu.mesh import structured  # noqa: E402
from p_a_multigrids_tpu.ops import fused  # noqa: E402
from p_a_multigrids_tpu.parallel.stencil_solver import (  # noqa: E402
    DistributedStencilSolver)

CYCLES = 10
AMG = dict(n_split=2, multi_levels=1, dt=0.05, ntime=1, n_multigrid=1,
           amg=True, agg_strength=0.5, cheb_degree=16, cheb_lower=0.05,
           dtype="float32")


def main(rows: int = 128, cols: int = 32) -> dict:
    t0 = time.time()
    mesh = structured.tri_mesh(rows, cols, 3 / rows, 1 / rows)
    dist = DistributedStencilSolver(mesh, SemiConfig(**AMG),
                                    devices=jax.devices()[:4])
    sv = dist.serial
    setup_s = time.time() - t0
    specs = dist._remap_specs((tuple(dist.specs), dist._phase_specs(),
                               dist._aspecs))
    tabs = (tuple(dist.tabs_dev), tuple(dist.ptabs_dev), dist.atabs_dev)

    def cycle_local(x, b, all_tabs):
        t, p, a = all_tabs
        return dist._vcycle(t, p, a, 0, x, b)

    cycle = jax.jit(jax.shard_map(
        cycle_local, mesh=dist.jmesh,
        in_specs=(dist._xspec, dist._xspec, specs),
        out_specs=dist._xspec, check_vma=False))
    serial_cycle = jax.jit(lambda x, b: sv._vcycle_t(0, x, b))
    residual = jax.jit(lambda x, b: jnp.max(jnp.abs(
        b - sv._apply_t(0, x, True))))

    T0 = fused.to_t(sv.initial_condition())
    b = sv._rhs_t(T0)
    sh = NamedSharding(dist.jmesh, dist._xspec)
    xd, bd = jax.device_put(T0, sh), jax.device_put(b, sh)
    xs = T0
    hist, shist, rel = [], [], []
    for _ in range(CYCLES):
        xd = cycle(xd, bd, tabs)
        xs = serial_cycle(xs, b)
        g = float(residual(jnp.asarray(np.asarray(xd)), b))
        w = float(residual(xs, b))
        hist.append(g)
        shist.append(w)
        rel.append(abs(g - w) / w)
    x_rel = float(np.abs(np.asarray(xd) - np.asarray(xs)).max()
                  / np.abs(np.asarray(xs)).max())
    out = dict(mesh=[rows, cols], dof=3 * 16 * mesh.num_elements,
               devices=4, dtype="float32", setup_s=round(setup_s, 1),
               seconds=round(time.time() - t0, 1), history=hist,
               serial_history=shist, rel_distance=rel,
               iterate_rel_distance=x_rel)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))

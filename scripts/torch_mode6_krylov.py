"""BiCGStab iterations a step of mode 6 at full width, on the PyTorch port
and on the JAX package, both float32 on the CPU.

    PYTHONPATH=. python scripts/torch_mode6_krylov.py [N]

Mode 6 as the port's ``utils.profiling.MODE6_ARGS`` run it (Crank-Nicolson
advection-diffusion, u = (1, 0), 2 steps, BiCGStab to 1e-8, at most 200
iterations) on ``painted_mesh(N)`` (default 256: 131,072 elements,
393,216 DOF).  The port's steps run its plain PyTorch path
(``SemiSolver._step_t`` on CPU tensors, which records the iterations);
the JAX package's run ``p_a_multigrids_tpu.ops.krylov.bicgstab`` from the
same states, as its ``_solve_system_t`` does.  Prints one JSON line with
both iteration lists, the seconds each took and the largest difference of
the two final states.
"""

import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from p_a_multigrids_tpu import config as jcfg  # noqa: E402
from p_a_multigrids_tpu.mesh import structured as jstruct  # noqa: E402
from p_a_multigrids_tpu.models import semi as jsemi  # noqa: E402
from p_a_multigrids_tpu.models import transport as jtransport  # noqa: E402
from p_a_multigrids_tpu.ops import krylov as jkrylov  # noqa: E402

from p_a_multigrids_tpu_torch import __main__ as tcli  # noqa: E402
from p_a_multigrids_tpu_torch.ops.fused import to_t  # noqa: E402
from p_a_multigrids_tpu_torch.utils import profiling  # noqa: E402


def main(n: int = 256) -> dict:
    mesh = profiling.painted_mesh(n)
    t0 = time.time()
    sv = profiling.transport_solver("cpu", mesh)
    T_t = to_t(sv.initial_condition())
    for _ in range(sv.cfg.ntime):
        T_t = sv._step_t(T_t)
    port_s = time.time() - t0

    # the same configuration through the JAX package's own setup
    args, _ = tcli._parse(profiling.MODE6_ARGS + ["--device", "cpu"])
    tc = tcli._transport_cfg(args)
    jc = jtransport._semi_cfg(jcfg.TransportConfig(
        ntime=tc.ntime, dt=tc.dt, u=tc.u, k=tc.k, diffusion=tc.diffusion,
        implicit=tc.implicit, theta=tc.theta, dtype=tc.dtype),
        jcfg.ProblemFns())
    jmesh = jstruct.tri_mesh(n, n, 1.0 / n, 1.0 / n)
    jmesh.region_id = mesh.region_id
    t0 = time.time()
    js = jsemi.SemiSolver(jsemi.build_problem(jmesh, jc))
    op = js._stencil[0]
    A_lin = jax.jit(lambda x: js._apply_t(0, x, False))
    precond = jax.jit(lambda r: js._vcycle_t(0, jnp.zeros_like(r), r,
                                             hom=True))
    x_t = jnp.asarray(np.asarray(js.initial_condition()).transpose(2, 1, 0))
    jax_iters = []
    for _ in range(jc.ntime):
        b = js._rhs_t(x_t)
        b_lin = b - op.apply(jnp.zeros_like(b), True)
        x_t, it, _ = jkrylov.bicgstab(A_lin, b_lin, x_t, precond=precond,
                                      tol=jc.krylov_tol,
                                      maxiter=jc.krylov_maxiter)
        jax_iters.append(int(it))
    jax_s = time.time() - t0
    out = {"elements": mesh.num_elements, "port_cpu_iterations":
           list(sv.krylov_iters), "jax_cpu_iterations": jax_iters,
           "port_seconds": port_s, "jax_seconds": jax_s,
           "max_abs_diff": float(np.abs(T_t.numpy() - np.asarray(x_t)).max()),
           "max_abs_T": float(np.abs(np.asarray(x_t)).max())}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))

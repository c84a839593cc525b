"""V- and W-cycles of the port at n_split 5 (C = 1024 children per macro)
== the JAX package's, float64 on the CPU, to 1e-11: 1 level (the single
level), 2 (SA levels below the geometric coarsest), 5 and 6 (the dense
coarse solve).

The Chebyshev degree is 3, not the level sweep's 6: the JAX package
compiles a W-cycle over six levels as one unrolled graph, and its compile
time grows with the rounds per phase (about 25 s at degree 6).  The
degree-6 phases at C = 256 and 1024 are held against JAX in
tests/test_torch_deep.py.
"""

import torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import semi as jsemi

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.models import semi as tsemi

MESH = (2, 1, 0.5, 0.5)                     # U = 4, C = 1024 at n_split 5


# levels -> extra config; with 2 levels the coarsest (n_split 4, 3,072 DOF)
# would take the dense solve, so it is forced into SA levels below
DEEP_LEVELS = {1: {}, 2: dict(coarse_direct_max_dof=0, agg_dense_max_dof=96),
               5: {}, 6: {}}


@pytest.mark.parametrize("cycle", ["v", "w"])
@pytest.mark.parametrize("levels", list(DEEP_LEVELS))
def test_deep_cycle_matches_jax(levels, cycle):
    kw = dict(n_split=5, multi_levels=levels, dt=1e8, ntime=1,
              n_multigrid=1, cheb_degree=3, cycle_type=cycle,
              dtype="float64", **DEEP_LEVELS[levels])
    js = jsemi.SemiSolver(jsemi.build_problem(
        jstruct.tri_mesh(*MESH), jcfg.SemiConfig(pallas_phase=False, **kw)))
    ts = tsemi.SemiSolver(tsemi.build_problem(
        tstruct.tri_mesh(*MESH), tcfg.SemiConfig(**kw)), "cpu")
    assert [op.C for op in ts.ops] == [4 ** (5 - i) for i in range(levels)]
    assert (ts.agg is not None) == (levels == 2)
    assert (ts.coarse_inv_t is not None) == (levels >= 5)
    T_t = np.random.default_rng(levels).normal(size=(3, 1024, 4))
    want = np.asarray(js._step_t(jnp.asarray(T_t)))
    got = ts._step_t(torch.tensor(T_t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)

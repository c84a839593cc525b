"""The bare time step's cycles off the card: the CPU, and the cases in
which the card's predicate (``SemiSolver._graphable``) leaves the cycles
eager too (an SA level, coarse CG, a point smoother).  Each step gives
the eager cycles' result bit for bit, the solver keeps no graph, and no
``step_graph_*`` counter counts.  On the card the cycles of a
geometric-only hierarchy with K1 phases replay as one CUDA graph
(``tests/test_torch_cuda.py``)."""

import torch_threads  # noqa: F401

import types

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu_torch.config import SemiConfig, Solver
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.utils import tracing

MESH = (2, 2, 0.5, 0.5)
BASE = dict(n_split=2, multi_levels=2, n_multigrid=2, dt=0.05,
            coarse_agg=False, dtype="float64")
# the configuration changes, and whether the card would replay the step
CASES = {"geometric": ({}, True),
         "sa_level": (dict(amg=True, multi_levels=1), False),
         "coarse_cg": (dict(coarse_krylov=True), False),
         "point_smoother": (dict(solver=Solver.JACOBI), False)}


@pytest.mark.parametrize("case", CASES)
def test_bare_step_runs_eagerly_off_the_card(case):
    kw, on_card = CASES[case]
    cfg = SemiConfig(**{**BASE, **kw})
    solver = semi.SemiSolver(
        semi.build_problem(structured.tri_mesh(*MESH), cfg), "cpu")
    T = solver.initial_condition()
    rng = np.random.default_rng(3)
    T_t = semi.to_t(T + torch.as_tensor(rng.normal(size=T.shape)))
    card = types.SimpleNamespace(device=torch.device("cuda"))
    assert solver._graphable(card) == on_card
    assert not solver._graphable(T_t)
    tracing.reset()
    got = solver._step_t(T_t)
    counters = tracing.snapshot()["counters"]
    b_t = solver._rhs_t(T_t)
    want = T_t
    for _ in range(cfg.n_multigrid):
        want = solver._vcycle_t(0, want, b_t)
    assert torch.equal(got, want)
    assert solver._graphs == {}
    assert counters["steps"] == 1
    assert not [n for n in counters if n.startswith("step_graph_")]

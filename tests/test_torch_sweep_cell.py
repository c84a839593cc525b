"""The benchmark's level-sweep cell (``sweep98304_ns5.w6_pcg``: 6-level
geometric W-cycles as PCG's preconditioner at n_split 5) on the CPU, on
two macros (6,144 DOF) in place of its 96: the port's step held to the
plain reference's check (``pamg_bench.reference.check.SolveCheck``), and
its preconditioner, which replays a CUDA graph only on the card."""

import torch_threads  # noqa: F401

import json
import pathlib

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu_torch.config import SemiConfig
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.utils import tracing

from pamg_bench import traffic
from pamg_bench.reference import check, dg

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (1, 1, 1.0, 0.75)
SEED = 2 ** 31 + 977
# the largest rel_residual a step may leave: PCG stops at 1e-6 of ||b|| in
# the port's own arithmetic; float32 rounding of the operator and the
# state moves the reference's float64 residual further
LIMIT = {"float64": 1e-6, "float32": 1e-5}


def _cell():
    """The cell's SemiConfig fields and traffic mix, as the benchmark
    reads them (``spec.Cell.semi_fields``)."""
    conf = json.loads((ROOT / "pamg_bench" / "configs" /
                       "sweep98304_ns5.json").read_text())
    mix = json.loads((ROOT / "pamg_bench" / "traffic" /
                      "w6_pcg.json").read_text())
    return {**conf["semi"], **mix["semi"]}, mix


@pytest.fixture(scope="module", params=["float64", "float32"])
def solver(request):
    fields, _ = _cell()
    fields["dtype"] = request.param
    cfg = SemiConfig(**fields)
    return semi.SemiSolver(semi.build_problem(structured.tri_mesh(*MESH),
                                              cfg), "cpu")


def test_w6_pcg_step_passes_the_reference_check(solver):
    """Two of the mix's seeded initial states, each solved by one step:
    the relative residual in the reference's own float64 system stays
    within LIMIT of the step's dtype, after 6-level W-cycle PCG."""
    fields, mix = _cell()
    fields["dtype"] = solver.cfg.dtype
    X = dg.structured_macro_X(*MESH)
    ics = traffic.initial_states(dg.child_coords(X, fields["n_split"]), mix,
                                 SEED, "cpu", solver.dtype)
    st = solver.stepper()
    reference = check.SolveCheck(X, fields)
    assert len(solver.p.levels) == 6 and solver.cfg.cycle_type == "w"
    for ic in ics[:2]:
        x = st.from_state(st.step(st.to_state(ic)))
        number = reference.number(ic.double().numpy().reshape(-1),
                                  x.double().numpy().reshape(-1))
        assert number <= LIMIT[solver.cfg.dtype]
        assert 0 < solver.krylov_iters[-1] < solver.cfg.krylov_maxiter


def test_geometric_preconditioner_runs_eagerly_on_the_cpu(solver):
    """On the CPU the preconditioner captures no graph: it gives the eager
    cycle's result bit for bit, the solver keeps no graph, and a step
    counts no ``mg_graph_*`` counter."""
    rng = np.random.default_rng(5)
    r = torch.tensor(rng.normal(size=(3, solver.ops[0].C,
                                      solver.ops[0].U)), dtype=solver.dtype)
    st = solver.stepper()
    tracing.reset()
    got = solver._precond_t(r)
    st.step(st.to_state(solver.initial_condition()))
    counters = tracing.snapshot()["counters"]
    want = solver._vcycle_t(0, torch.zeros_like(r), r, hom=True)
    assert torch.equal(got, want)
    assert solver._graphs == {}
    assert counters["steps"] == 1
    assert not [n for n in counters if n.startswith("mg_graph_")]

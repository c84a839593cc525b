"""The benchmark's scaling-row cell (``scale589824_ns7.v8_pcg``: n_split
7, C = 16,384 children a macro) on the CPU, on two macros (98,304 DOF) in
place of its 36: the default split cap takes the stencil path there (the
CLI's too) and the fused path stays reachable through the configuration;
one PCG step on the stencil path held to the plain reference's system;
the stencil operator's apply against ``FusedOperator``'s."""

import torch_threads  # noqa: F401

import dataclasses
import json
import pathlib

import pytest
import torch

from p_a_multigrids_tpu_torch import __main__ as cli
from p_a_multigrids_tpu_torch.config import SemiConfig
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.ops.fused import FusedOperator

from pamg_bench import traffic
from pamg_bench.reference import check, dg

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (1, 1, 1.0, 0.5)
SEED = 2 ** 31 + 977


def _cell(**kw) -> dict:
    """The cell's SemiConfig fields, as the benchmark reads them
    (``spec.Cell.semi_fields``), in float64 and with ``kw`` on top."""
    conf = json.loads((ROOT / "pamg_bench" / "configs" /
                       "scale589824_ns7.json").read_text())
    mix = json.loads((ROOT / "pamg_bench" / "traffic" /
                      "v8_pcg.json").read_text())
    return {**conf["semi"], **mix["semi"], "dtype": "float64", **kw}


@pytest.fixture(scope="module")
def problem():
    """Four of the cell's eight levels (C = 16,384 down to 256) on two
    macros: the coarsest, 1,536 DOF, is a dense solve, as the cell's C = 1
    level is."""
    cfg = SemiConfig(**_cell(multi_levels=4, krylov_tol=1e-9))
    return semi.build_problem(structured.tri_mesh(*MESH), cfg)


@pytest.fixture(scope="module")
def solver(problem):
    return semi.SemiSolver(problem, "cpu")


@pytest.mark.parametrize("kw,stencil", [
    ({}, True), ({"stencil_max_children": 4096}, False),
    ({"stencil_operator": False}, False)],
    ids=["default", "jax_cap", "no_stencil"])
def test_n_split7_path_choice(problem, kw, stencil):
    """By default n_split 7 (4**7 = 16,384 children a macro, the port's
    cap) takes the stencil path with K1 phases; the JAX package's cap of
    4,096, or ``stencil_operator=False``, the fused operator (a solver of
    the finest level alone)."""
    default = {"stencil_max_children": SemiConfig().stencil_max_children}
    cfg = dataclasses.replace(problem.cfg, multi_levels=1,
                              **{**default, **kw})
    sv = semi.SemiSolver(dataclasses.replace(
        problem, cfg=cfg, levels=problem.levels[:1]), "cpu")
    assert sv.stencil is stencil and sv.phase_cycle is stencil
    assert (sv.fused is None) is stencil
    assert [op.C for op in sv.ops] == ([4 ** 7] if stencil else [])


def test_n_split7_cli_takes_the_stencil_path():
    """The CLI builds the stencil path at n_split 7, and n_split 8 stays
    above the cap."""
    sv = cli.setup(["--mode", "9", "--n-split", "7", "--rows", "1",
                    "--cols", "1", "--levels", "1", "--device", "cpu"])[2]
    assert sv.stencil and sv.ops[0].C == 4 ** 7
    assert 4 ** 8 > SemiConfig().stencil_max_children >= 4 ** 7


def test_pcg_step_meets_the_reference(solver):
    """One step from a seeded initial state of the cell's mix, by PCG
    under the four-level V-cycle of K1 phases (the plain version on the
    CPU): its relative residual in the reference's own float64 system is
    at most 1e-8 (PCG stops at 1e-9 of ||b|| in the port's arithmetic)."""
    fields = _cell()
    mix = json.loads((ROOT / "pamg_bench" / "traffic" /
                      "v8_pcg.json").read_text())
    X = dg.structured_macro_X(*MESH)
    ic = traffic.initial_states(dg.child_coords(X, fields["n_split"]), mix,
                                SEED, "cpu", solver.dtype)[0]
    st = solver.stepper()
    x = st.from_state(st.step(st.to_state(ic)))
    number = check.SolveCheck(X, fields).number(
        ic.double().numpy().reshape(-1), x.double().numpy().reshape(-1))
    assert solver.stencil and [op.C for op in solver.ops] == [
        16384, 4096, 1024, 256]
    assert solver.coarse_inv_t is not None
    assert number <= 1e-8
    assert 0 < solver.krylov_iters[-1] < solver.cfg.krylov_maxiter


@pytest.mark.parametrize("with_bc", [False, True])
def test_stencil_apply_equals_fused(solver, with_bc):
    """The fine level's block-stencil apply equals the fused operator's on
    the same tables, to 1e-12 of the result's largest value."""
    cfg = solver.cfg
    L = semi.level_tensors(solver.p.levels[0], "cpu")
    fused = FusedOperator(L, cfg.physics, cfg.dt, cfg.theta, "cpu")
    g = torch.Generator().manual_seed(7)
    x = torch.randn((3, 4 ** 7, 2), generator=g, dtype=torch.float64)
    want = fused.apply(x, with_bc)
    got = solver.ops[0].apply(x, with_bc)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())

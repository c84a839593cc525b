"""The geometric level transfers (``ops.transfer``) on the CPU: the plain
versions the card's kernels are held to, at every level pair of n_split 5
down to 0, against the composition of ``restrict_t`` / ``prolong_t`` the
cycle ran before and against the formula in NumPy; the cycle that now
hands a phase's z to the restriction, bit for bit the cycle that formed
the residual first (a W-cycle of the level sweep's cell and a bare
V-cycle step); the tables' check when a solver is built and the shape
check of every call; and a CUDA graph's replay crediting each of its
kernels' counters."""

import torch_threads  # noqa: F401

import json
import pathlib

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu_torch.config import SemiConfig
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.ops import cuda_graph, transfer
from p_a_multigrids_tpu_torch.ops.phase import phase
from p_a_multigrids_tpu_torch.ops.transfer import prolong_t, restrict_t
from p_a_multigrids_tpu_torch.utils import tracing

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the level sweep's cell on two macros (as tests/test_torch_sweep_cell.py)
SWEEP_MESH = (1, 1, 1.0, 0.75)
V_MESH = (8, 4, 3 / 8, 1 / 8)


def _sweep_solver(dtype: str) -> semi.SemiSolver:
    conf = json.loads((ROOT / "pamg_bench" / "configs" /
                       "sweep98304_ns5.json").read_text())
    mix = json.loads((ROOT / "pamg_bench" / "traffic" /
                      "w6_pcg.json").read_text())
    cfg = SemiConfig(**{**conf["semi"], **mix["semi"], "dtype": dtype})
    return semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(*SWEEP_MESH), cfg), "cpu")


@pytest.fixture(scope="module")
def sweep64():
    return _sweep_solver("float64")


def _formula(S, r, fine_of, pw):
    """bc[k, cc, u] = sum_m sum_l pw[f, l, k] (S r)[l, f, u], f =
    fine_of[cc, m], in NumPy; S None is the identity."""
    Sr = r if S is None else np.einsum("ljfu,jfu->lfu", S, r)
    contrib = np.einsum("flk,lfu->kfu", pw, Sr)
    return sum(contrib[:, fine_of[:, m]] for m in range(4))


@pytest.mark.parametrize("li", [0, 1, 2, 3, 4])
def test_plain_transfers_match_the_composition(sweep64, li):
    """Level li (C = 4^(5 - li)) to li + 1 of the level sweep, float64:
    the restriction of a phase's z with the self blocks equals
    restrict_t(op.mul_self(z)) and the formula, the restriction of a
    residual (no blocks) the formula, the prolongation with the add
    x + prolong_t(e) and the formula, each at 1e-12; and the restriction
    is the prolongation's transpose."""
    s, op = sweep64, sweep64.ops[li]
    C, U = op.C, op.U
    assert C == 4 ** (5 - li)
    fine_of, parent, pw = (getattr(s, f"{n}_{li + 1}")
                           for n in ("fine_of", "parent", "pweights"))
    rng = np.random.default_rng(li)
    z, x = (torch.tensor(rng.normal(size=(3, C, U))) for _ in range(2))
    e = torch.tensor(rng.normal(size=(3, C // 4, U)))

    def close(got, want):
        want = torch.as_tensor(want)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())

    fo, pa, w = fine_of.numpy(), parent.numpy(), pw.numpy()
    got = s._restrict_t(z, li + 1, op.S_t)
    close(got, restrict_t(op.mul_self(z), fine_of, pw))
    close(got, _formula(op.S_t.numpy(), z.numpy(), fo, w))
    got = s._restrict_t(z, li + 1)
    close(got, _formula(None, z.numpy(), fo, w))
    got = s._prolong_add_t(x, e, li + 1)
    close(got, x + prolong_t(e, parent, pw))
    close(got, x.numpy() + np.einsum("flk,kfu->lfu", w, e.numpy()[:, pa]))
    # <P^T r, e> = <r, P e>
    Pe = s._prolong_add_t(torch.zeros_like(x), e, li + 1)
    lhs, rhs = float((s._restrict_t(z, li + 1) * e).sum()), float(
        (z * Pe).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


def _composed_cycle(s, li, x_t, b_t, hom=False):
    """The phase cycle as it ran before the transfers took a phase's z:
    the residual formed by ``mul_self``, then ``restrict_t``; the
    correction added to ``prolong_t``'s output."""
    cfg, nl = s.cfg, len(s.p.levels)
    with_bc = li == 0 and not hom
    coarsest = li == nl - 1
    if coarsest and nl > 1 and s.coarse_inv_t is not None:
        return s._coarse_direct_t(x_t, b_t)
    op = s.ops[li]
    bp = op._bp(b_t, with_bc)

    def smooth(x, sweeps, want_r):
        x, z = phase(op, x, bp, s._phase_coefs(li, sweeps), want_z=want_r)
        return x, (op.mul_self(z) if want_r else None)

    if coarsest:
        sweeps = cfg.coarse_sweeps if nl > 1 else cfg.n_smooth
        return smooth(x_t, sweeps, False)[0]
    x_t, r_t = smooth(x_t, cfg.n_smooth, True)
    fine_of, parent, pw = (getattr(s, f"{n}_{li + 1}")
                           for n in ("fine_of", "parent", "pweights"))
    bc = restrict_t(r_t, fine_of, pw)
    e = _composed_cycle(s, li + 1, torch.zeros_like(bc), bc, hom)
    if cfg.cycle_type == "w" and li < 2:
        e = _composed_cycle(s, li + 1, e, bc, hom)
    x_t = x_t + prolong_t(e, parent, pw)
    return smooth(x_t, cfg.n_smooth, False)[0]


@pytest.mark.parametrize("case", ["w6_preconditioner", "v2_bare_step"])
def test_cycle_is_the_composed_cycle_bit_for_bit(case):
    """The level sweep's 6-level W-cycle as PCG's preconditioner (float32,
    homogeneous) and a bare 2-level V-cycle from the initial state with the
    Dirichlet ghosts (float64): ``_vcycle_t`` gives the composed cycle's
    state bit for bit."""
    if case == "w6_preconditioner":
        s = _sweep_solver("float32")
        assert s.cfg.cycle_type == "w" and len(s.p.levels) == 6
        r = torch.tensor(np.random.default_rng(5).normal(
            size=(3, s.ops[0].C, s.ops[0].U)), dtype=s.dtype)
        args, hom = (torch.zeros_like(r), r), True
    else:
        s = semi.SemiSolver(semi.build_problem(
            structured.tri_mesh(*V_MESH),
            SemiConfig(n_split=2, multi_levels=2, dt=0.05,
                       dtype="float64")), "cpu")
        T_t = semi.to_t(s.initial_condition())
        args, hom = (T_t, s._rhs_t(T_t)), False
    want = _composed_cycle(s, 0, *args, hom=hom)
    assert torch.equal(s._vcycle_t(0, *args, hom=hom), want)


@pytest.mark.parametrize("table", ["fine_of", "parent"])
def test_transfer_tables_are_checked_at_setup(table, monkeypatch):
    """A transfer table with an index outside its range makes the solver's
    build raise IndexError: the kernels read the tables unchecked."""
    real = semi._transfer_tables

    def corrupted(n_coarse):
        fine_of, parent, pweights = (a.copy() for a in real(n_coarse))
        if table == "fine_of":
            fine_of[-1, 2] = 4 ** (n_coarse + 1)
        else:
            parent[0] = -1
        return fine_of, parent, pweights

    monkeypatch.setattr(semi, "_transfer_tables", corrupted)
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.05)
    with pytest.raises(IndexError, match=table):
        semi.SemiSolver(semi.build_problem(structured.tri_mesh(*V_MESH),
                                           cfg), "cpu")


def test_check_tables_refuses_shapes_and_types():
    fine_of, parent, pw = semi._transfer_tensors(1, torch.empty(()))
    transfer.check_tables(fine_of, parent, pw, 16)
    with pytest.raises(ValueError, match="pweights"):
        transfer.check_tables(fine_of, parent, pw[:15], 16)
    with pytest.raises(ValueError, match="fine_of"):
        transfer.check_tables(fine_of, parent, pw, 64)
    with pytest.raises(TypeError, match="int64"):
        transfer.check_tables(fine_of.int(), parent, pw, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        transfer.restrict(torch.empty((3, 16, 2), device="meta"), fine_of,
                          pw)


@pytest.mark.parametrize("case", ["dofs", "fine_of", "S", "e", "parent"])
def test_transfers_refuse_mismatched_shapes(case):
    """Operands that do not fit the tables, or each other, raise before
    any kernel could read past them (the check runs on every device)."""
    fine_of, parent, pw = semi._transfer_tensors(1, torch.empty(()))
    z, e = torch.zeros((3, 16, 5)), torch.zeros((3, 4, 5))
    call = {
        "dofs": lambda: transfer.restrict(torch.zeros((2, 16, 5)), fine_of,
                                          pw),
        "fine_of": lambda: transfer.restrict(torch.zeros((3, 64, 5)),
                                             fine_of, pw),
        "S": lambda: transfer.restrict(z, fine_of, pw,
                                       torch.zeros((3, 3, 16, 4))),
        "e": lambda: transfer.prolong_add(z, e[..., :4], parent, pw),
        "parent": lambda: transfer.prolong_add(z, e, parent[:8], pw),
    }[case]
    with pytest.raises(ValueError, match="has shape"):
        call()


class _Kernel:
    COUNTERS = ("launches", "by_entry")

    def __init__(self):
        self.launches = 0
        self.by_entry = {"restrict": 0, "prolong_add": 0}


class _Replay:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_credits_each_kernel_of_its_kind():
    """A replay adds to each kernel object what the capture recorded, its
    tallies by entry too, and counts ``<prefix>_<name>_launches`` for each
    of the kind's kernels and the first kernel's least bytes; the
    snapshot reports the transfer kernels' launches."""
    k1, k1_checked, tr = _Kernel(), _Kernel(), _Kernel()
    kind = cuda_graph.Kind("pamg.test.graph", "test_graph",
                           (("k1", (k1, k1_checked)), ("transfer", (tr,))),
                           copy_out=True)
    stub = _Replay()
    y = torch.arange(3.0)
    none = {"restrict": 0, "prolong_add": 0}
    graph = cuda_graph.Graph(
        kind, stub, (torch.zeros(3),), y, (),
        {"k1": ({"launches": 30, "by_entry": none},
                {"launches": 0, "by_entry": none}),
         "transfer": ({"launches": 30, "by_entry": {"restrict": 15,
                                                    "prolong_add": 15}},)},
        1234)
    assert graph.launches("k1") == graph.launches("transfer") == 30
    tracing.reset()
    for _ in range(2):
        out = graph(torch.ones(3))
    assert stub.replays == 2 and torch.equal(out, y) and out is not y
    assert (k1.launches, k1_checked.launches, tr.launches) == (60, 0, 60)
    assert tr.by_entry == {"restrict": 30, "prolong_add": 30}
    assert tracing.snapshot()["counters"] == {
        "test_graph_k1_launches": 60, "test_graph_transfer_launches": 60,
        "test_graph_k1_least_bytes": 2468, "test_graph_replays": 2}
    tracing.reset()


def test_snapshot_reports_the_transfer_kernels(monkeypatch):
    """``snapshot()["kernels"]["transfer"]`` is the transfer kernels'
    launch count, which ``reset`` sets to 0 with the tallies by entry."""
    monkeypatch.setattr(transfer, "KERNEL", transfer.TransferKernel())
    assert tracing.snapshot()["kernels"]["transfer"] == 0
    transfer.KERNEL.launches = 7
    transfer.KERNEL.by_entry["restrict"] = 4
    assert tracing.snapshot()["kernels"]["transfer"] == 7
    transfer.KERNEL.reset()
    assert transfer.KERNEL.launches == 0
    assert transfer.KERNEL.by_entry == {"restrict": 0, "prolong_add": 0}

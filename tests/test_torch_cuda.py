"""Kernels K1 and K2 on the GPU == their plain PyTorch versions
(phase_reference, rowop_reference), and the mode-10 and BiCGStab steps that
run through them == the same steps on the CPU.

This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Without a CUDA
device the kernel tests skip; the build test runs only where there is no
CUDA compiler.
"""

import torch_threads  # noqa: F401

import json
import os

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu_torch.config import SemiConfig
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.mesh import splitting
from p_a_multigrids_tpu_torch.ops import agg
from p_a_multigrids_tpu_torch.ops import phase as K
from p_a_multigrids_tpu_torch.ops import smoothers, spmv, stencil, transfer
from p_a_multigrids_tpu_torch.utils import cuda_build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels K1 and K2 run only on "
                    "the GPU")
    return torch.device("cuda")


def _k1_matches_plain(op, x, bp, coefs, want_z, rtol, tier=None):
    """One K1 phase against phase_reference: one launch (in ``tier`` when
    given), len(coefs) + want_z rounds, and the launch also in
    launches_deep at C > DEEP_C."""
    n0, d0, r0 = K.KERNEL.launches, K.KERNEL.launches_deep, K.KERNEL.rounds
    t0 = dict(K.KERNEL.by_tier)
    xk, zk = K.phase_on_tier(op, x, bp, coefs, want_z, tier)
    torch.cuda.synchronize()
    rounds = len(coefs) + int(want_z)
    assert K.KERNEL.launches - n0 == -(-rounds // K.MAX_ROUNDS)
    assert K.KERNEL.rounds - r0 == rounds
    assert K.KERNEL.launches_deep - d0 == (
        K.KERNEL.launches - n0 if op.C > K.DEEP_C else 0)
    used = K.KERNEL.plan(op, tier).tier
    assert K.KERNEL.by_tier[used] - t0[used] == K.KERNEL.launches - n0
    xr, zr = K.phase_reference(op, x, bp, coefs, want_z)
    pairs = [(xk, xr), (zk, zr)] if want_z else [(xk, xr)]
    for got, ref in pairs:
        err = float((got - ref).abs().max())
        assert err <= rtol * float(ref.abs().max())
    return used


def _k1_level(n_split, cuda, mesh=(6, 5, 0.2, 0.25), dtype=torch.float32):
    cfg = SemiConfig(n_split=n_split, multi_levels=1, dt=0.05)
    L = semi.build_problem(structured.tri_mesh(*mesh), cfg).levels[0]
    data = stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    op = stencil.StencilOperator(data, dtype, cuda)
    cheb = [1.0 / r for r in smoothers.chebyshev_roots(
        stencil.lam_max_estimate(data), 6, 0.1)]
    rng = np.random.default_rng(n_split)
    x, b = (torch.tensor(rng.normal(size=(3, op.C, op.U)), dtype=dtype,
                         device=cuda)
            for _ in range(2))
    return op, cheb, x, b


@pytest.mark.parametrize("n_split", [0, 1, 2, 3, 4, 5])
def test_k1_matches_plain(cuda, n_split):
    """f32 sums of ~40 terms taken in another order, compounded over <= 7
    rounds with intermediate Chebyshev amplification: 1e-4 relative for
    multi-round phases, 1e-5 for the zero-round apply.  n_split 0 has 3
    cross slots per child, 1-5 the corner children's 2; n_split 4 and 5
    (C = 256 and 1024) are the TPU's PhaseOperatorResident regime, counted
    in launches_deep too.  Each phase is one launch, in the tier phase_plan
    picks (small up to 1,263 pairs, resident above), and again forced to
    stream."""
    op, cheb, x, b = _k1_level(n_split, cuda)
    for tier in (None, "stream"):
        for coefs, want_z, bp, rtol in (
                (cheb, True, op._bp(b, True), 1e-4),
                ([0.8] * 3, False, op._bp(b, False), 1e-4),
                ([], True, torch.zeros_like(x), 1e-5)):
            _k1_matches_plain(op, x, bp, coefs, want_z, rtol, tier)


@pytest.mark.parametrize("tier", ["small", "resident", "stream"])
def test_k1_tiers(cuda, tier):
    """The resident and streaming tiers on a level too large for the small
    one (n_split 3 on 12 x 10 macros: 15,360 pairs), and the small tier on
    a level that fits it (n_split 2 on 6 x 5: 960 pairs)."""
    big = tier != "small"
    op, cheb, x, b = _k1_level(3 if big else 2, cuda,
                               (12, 10, 1 / 12, 0.1) if big else
                               (6, 5, 0.2, 0.25))
    assert K.KERNEL.plan(op).tier == ("resident" if big else "small")
    assert _k1_matches_plain(op, x, op._bp(b, True), cheb, True, 1e-4,
                             tier) == tier


def test_k1_splits_a_long_phase(cuda):
    """A phase of more than MAX_ROUNDS rounds runs as several launches that
    hand the state on without overwriting the buffer they read."""
    op, _, x, b = _k1_level(2, cuda)
    coefs = [0.3] * (K.MAX_ROUNDS + 5)
    _k1_matches_plain(op, x, op._bp(b, True), coefs, True, 1e-4)


# float64: the same sums in another order, each with products rounded at
# 2^-53 instead of 2^-24, so 1e-11 of the largest |output| for a phase
# (1e-4 in float32) and 1e-12 for K2 (1e-5)
F64_K1_RTOL = 1e-11
F64_K2_RTOL = 1e-12


def _k1_f64_level(tier, cuda):
    """A float64 level that phase_plan puts in ``tier``: n_split 2 on 4 x 4
    macros (512 pairs, at most 708 in the small tier), n_split 3 on
    12 x 10 (15,360 pairs, 117 a block: resident) and n_split 2 on
    128 x 32 (131,072 pairs, 993 a block: 278 KB, so it streams)."""
    n_split, mesh = {"small": (2, (4, 4, 0.25, 0.25)),
                     "resident": (3, (12, 10, 1 / 12, 0.1)),
                     "stream": (2, (128, 32, 3 / 128, 1 / 128))}[tier]
    return _k1_level(n_split, cuda, mesh, torch.float64)


@pytest.mark.parametrize("tier", ["small", "resident", "stream"])
def test_k1_float64_matches_plain(cuda, tier):
    """K1 in float64 in the tier its plan picks for the level (the bench's
    fine level streams in float64, it is resident in float32): a
    Chebyshev phase with z, a 3-round phase without and the zero-round
    apply, one launch each, within F64_K1_RTOL of phase_reference."""
    op, cheb, x, b = _k1_f64_level(tier, cuda)
    assert K.KERNEL.plan(op).tier == tier
    for coefs, want_z, bp in ((cheb, True, op._bp(b, True)),
                              ([0.8] * 3, False, op._bp(b, False)),
                              ([], True, torch.zeros_like(x))):
        assert _k1_matches_plain(op, x, bp, coefs, want_z,
                                 F64_K1_RTOL) == tier


@pytest.mark.parametrize("n_split", [0, 4, 5])
def test_k1_float64_at_c1_and_deep(cuda, n_split):
    """K1 in float64 at C = 1 (three cross slots a child) and in K3's
    regime (C = 256, 1024), in its own tier and forced to stream."""
    op, cheb, x, b = _k1_level(n_split, cuda, dtype=torch.float64)
    for tier in (None, "stream"):
        _k1_matches_plain(op, x, op._bp(b, True), cheb, True, F64_K1_RTOL,
                          tier)


def test_k1_float64_splits_a_long_phase(cuda):
    """A float64 phase of more than MAX_ROUNDS rounds: two launches handing
    the state on."""
    op, _, x, b = _k1_level(2, cuda, dtype=torch.float64)
    coefs = [0.3] * (K.MAX_ROUNDS + 5)
    _k1_matches_plain(op, x, op._bp(b, True), coefs, True, F64_K1_RTOL)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_k1_refuses_half_types(cuda, dtype):
    """Neither TPU kernel took 16-bit state, so K1 does not either."""
    op = _k1_level(1, cuda)[0].to(dtype)
    assert op.Fp_t.dtype == dtype
    x = torch.zeros((3, op.C, op.U), dtype=dtype, device=cuda)
    n0 = K.KERNEL.launches
    with pytest.raises(TypeError, match="float32 or float64"):
        K.phase(op, x, x, [0.5])
    assert K.KERNEL.launches == n0


def _k2_matches_plain(op, x, rtol=1e-5):
    """One K2 launch against rowop_reference: f32 sums of 3*D products
    (D <= 144) in another order, so 1e-5 of the largest |output| (rtol)."""
    n0 = spmv.KERNEL.launches
    got = op(x)
    torch.cuda.synchronize()
    assert spmv.KERNEL.launches - n0 == 1
    want = spmv.rowop_reference(*op.tables(), x)
    assert got.shape == want.shape == (3, op.n_out)
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max())


@pytest.mark.parametrize("variant", ["thread", "lanes"])
@pytest.mark.parametrize("shape", [(1000, 1000, 13), (300, 1000, 25),
                                   (1000, 300, 3), (257, 40, 141),
                                   (513, 2047, 141)])
def test_k2_matches_plain(cuda, shape, variant):
    """Square and rectangular random block rows, D up to the stand-in
    hierarchy's widest restriction (513 x 141 from 2,047 aggregates), in
    both variants: one thread a row, and lane groups (4 to 32 lanes)."""
    n_out, n_src, D = shape
    rng = np.random.default_rng(D)
    op = spmv.RowOp(rng.integers(0, n_src, size=(n_out, D)),
                    rng.normal(size=(n_out, D, 3, 3)), n_src,
                    torch.float32, cuda, variant)
    assert op.variant == variant
    x = torch.tensor(rng.normal(size=(3, n_src)), dtype=torch.float32,
                     device=cuda)
    _k2_matches_plain(op, x)


def test_k2_on_an_sa_hierarchy(cuda):
    """Every block-row operator of a real SA hierarchy (level operators,
    restrictions, prolongations, fine tentative transfers)."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05)
    mesh = structured.tri_mesh(12, 10, 1 / 12, 1 / 10)
    L = semi.build_problem(mesh, cfg).levels[0]
    data = stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    h = agg.AggHierarchy(agg.build_hierarchy(
        data, splitting.child_coords(mesh.X, 2), max_dense_dof=256,
        strength=0.5, always=True), torch.float32, cuda)
    assert len(h.levels) >= 2
    rng = np.random.default_rng(0)
    variants = set()
    for op in h.rowops().values():
        x = torch.tensor(rng.normal(size=(3, op.n_src)),
                         dtype=torch.float32, device=cuda)
        _k2_matches_plain(op, x)
        variants.add(op.variant)
    assert variants == {"thread", "lanes"}


def test_k2_variants_agree_bit_for_bit(cuda):
    """The lane-group variant adds each row's slot sums in slot order, as
    the thread variant does, so the two give the same bits; on every rowop
    of an SA hierarchy and on the widest random shape."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05)
    mesh = structured.tri_mesh(12, 10, 1 / 12, 1 / 10)
    L = semi.build_problem(mesh, cfg).levels[0]
    data = stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    h = agg.AggHierarchy(agg.build_hierarchy(
        data, splitting.child_coords(mesh.X, 2), max_dense_dof=256,
        strength=0.5, always=True), torch.float32, "cpu")
    rng = np.random.default_rng(1)
    shapes = []
    for op in h.rowops().values():
        cols_t, vals_t = op.tables()
        shapes.append((cols_t.T.numpy(), vals_t.permute(3, 0, 1, 2).numpy(),
                       op.n_src))
    shapes.append((rng.integers(0, 2047, size=(513, 141)),
                   rng.normal(size=(513, 141, 3, 3)), 2047))
    for cols, vals, n_src in shapes:
        x = torch.tensor(rng.normal(size=(3, n_src)), dtype=torch.float32,
                         device=cuda)
        got = [spmv.RowOp(cols, vals, n_src, torch.float32, cuda, v)(x)
               for v in ("thread", "lanes")]
        assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("variant", ["thread", "lanes"])
@pytest.mark.parametrize("shape", [(1000, 1000, 13), (300, 1000, 25),
                                   (1000, 300, 3), (513, 2047, 141),
                                   (40, 60, 512)])
def test_k2_float64_matches_plain(cuda, shape, variant):
    """K2 in float64, square and rectangular, both variants (up to 512
    slots a row in the lanes variant: 48 KB of float64 slot sums a
    block), within F64_K2_RTOL of rowop_reference; the two variants give
    the same bits."""
    n_out, n_src, D = shape
    rng = np.random.default_rng(D + 1)
    cols = rng.integers(0, n_src, size=(n_out, D))
    vals = rng.normal(size=(n_out, D, 3, 3))
    op = spmv.RowOp(cols, vals, n_src, torch.float64, cuda, variant)
    assert op.variant == variant and op.vals_t.dtype == torch.float64
    x = torch.tensor(rng.normal(size=(3, n_src)), dtype=torch.float64,
                     device=cuda)
    _k2_matches_plain(op, x, F64_K2_RTOL)
    other = "lanes" if variant == "thread" else "thread"
    assert torch.equal(op(x), spmv.RowOp(cols, vals, n_src, torch.float64,
                                         cuda, other)(x))


def test_k2_float64_on_an_sa_hierarchy(cuda):
    """Every rowop of a float64 SA hierarchy, as the float64 solver builds
    it (the host tables in float64)."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05, dtype="float64")
    mesh = structured.tri_mesh(12, 10, 1 / 12, 1 / 10)
    L = semi.build_problem(mesh, cfg).levels[0]
    data = stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    h = agg.AggHierarchy(agg.build_hierarchy(
        data, splitting.child_coords(mesh.X, 2), max_dense_dof=256,
        strength=0.5, always=True, dtype=np.float64), torch.float64, cuda)
    rng = np.random.default_rng(5)
    variants = set()
    for op in h.rowops().values():
        x = torch.tensor(rng.normal(size=(3, op.n_src)),
                         dtype=torch.float64, device=cuda)
        _k2_matches_plain(op, x, F64_K2_RTOL)
        variants.add(op.variant)
    assert variants == {"thread", "lanes"}


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_k2_refuses_half_types(cuda, dtype):
    op = spmv.RowOp(np.zeros((4, 2), np.int64), np.ones((4, 2, 3, 3)), 4,
                    torch.float32, cuda).to(dtype)
    assert op.vals_t.dtype == dtype
    n0 = spmv.KERNEL.launches
    with pytest.raises(TypeError, match="float32 or float64"):
        op(torch.zeros((3, 4), dtype=dtype, device=cuda))
    assert spmv.KERNEL.launches == n0


# the level pairs of the benchmark's cells: (fine children, macros), the
# level sweep's C = 1024 -> 256 -> 64 -> 16 -> 4 -> 1 at U = 96 and the
# headline mesh's C = 16 -> 4 at U = 8192
TRANSFER_SHAPES = [(1024, 96), (256, 96), (64, 96), (16, 96), (4, 96),
                   (16, 8192)]
# largest distance from the plain version, relative to the output's norm
TRANSFER_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("Cf,U", TRANSFER_SHAPES)
def test_transfer_kernels_match_plain(cuda, Cf, U, dtype):
    """The restriction with the residual fused in (S z), the restriction
    of a residual (no S) and the prolongation with the add, one launch
    each, against ``restrict_reference`` / ``prolong_add_reference``."""
    fine_of, parent, pw = semi._transfer_tensors(
        Cf.bit_length() // 2 - 1, torch.empty((), dtype=dtype, device=cuda))
    rng = np.random.default_rng(Cf + U)

    def rand(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=dtype, device=cuda)

    z, S, x, e = rand(3, Cf, U), rand(3, 3, Cf, U), rand(3, Cf, U), rand(
        3, Cf // 4, U)
    n0, by0 = transfer.KERNEL.launches, dict(transfer.KERNEL.by_entry)
    got = [transfer.restrict(z, fine_of, pw, S),
           transfer.restrict(z, fine_of, pw),
           transfer.prolong_add(x, e, parent, pw)]
    torch.cuda.synchronize()
    assert transfer.KERNEL.launches - n0 == 3
    assert {k: v - by0[k] for k, v in transfer.KERNEL.by_entry.items()} == {
        "restrict": 2, "prolong_add": 1}
    want = [transfer.restrict_reference(z, fine_of, pw, S),
            transfer.restrict_reference(z, fine_of, pw),
            transfer.prolong_add_reference(x, e, parent, pw)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype and g.is_contiguous()
        assert float((g - w).norm()) <= TRANSFER_RTOL[dtype] * float(
            w.norm())


def test_transfer_kernels_refuse_what_they_do_not_take(cuda):
    """float16, operands on two devices and a table on the host raise
    before any launch."""
    fine_of, parent, pw = semi._transfer_tensors(
        1, torch.empty((), device=cuda))
    z = torch.zeros((3, 16, 8), device=cuda)
    n0 = transfer.KERNEL.launches
    with pytest.raises(TypeError, match="float32 or float64"):
        transfer.restrict(z.half(), fine_of, pw.half())
    with pytest.raises(ValueError, match="operands"):
        transfer.prolong_add(z, torch.zeros((3, 4, 8)), parent, pw)
    with pytest.raises(ValueError, match="table"):
        transfer.restrict(z, fine_of.cpu(), pw)
    assert transfer.KERNEL.launches == n0


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    """No fallback: without nvcc the build raises instead of degrading."""
    if (os.path.isfile("/usr/local/cuda/bin/nvcc")
            or cuda_build.shutil.which("nvcc")):
        pytest.skip("a CUDA compiler is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    for name in ("phase", "spmv", "transfer"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.load(name)


def _mode10(device, dtype="float32", **kw):
    from p_a_multigrids_tpu_torch.models import semi_assembled
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05, dtype=dtype, **kw)
    return semi_assembled.AssembledSemiSolver(semi.build_problem(
        structured.tri_mesh(12, 10, 1 / 12, 1 / 10), cfg), device)


def test_k2_on_a_mode10_operator(cuda):
    """The assembled DG operator (self + 3 faces, the thread variant) of
    mode 10, against rowop_reference."""
    op = _mode10(cuda).A
    assert (op.D, op.variant) == (4, "thread")
    x = torch.tensor(np.random.default_rng(3).normal(size=(3, op.n_src)),
                     dtype=torch.float32, device=cuda)
    _k2_matches_plain(op, x)


def test_mode10_step_on_the_card_matches_cpu(cuda):
    """One mode-10 step (8 sweeps, one K2 launch each) on the card against
    the same step on the CPU, both float32: 1e-5 of the largest value."""
    gpu, cpu = _mode10(cuda), _mode10("cpu")
    T = cpu.initial_condition() + torch.tensor(np.random.default_rng(4).normal(
        size=tuple(cpu.analytical.shape)), dtype=torch.float32)
    n0 = spmv.KERNEL.launches
    got = gpu._step(T.to(cuda))
    torch.cuda.synchronize()
    assert spmv.KERNEL.launches - n0 == gpu.sweeps() == 8
    want = cpu._step(T)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("kw", [{}, {"amg": True, "multi_levels": 1,
                                     "krylov": True}, "mode10"],
                         ids=["geometric", "amg_krylov", "mode10"])
def test_float64_step_on_the_card_matches_cpu(cuda, kw):
    """A float64 step on the card (K1 and K2 in float64) against the same
    step on the CPU: float64 sums in another order, 1e-10 of the largest
    value; the card's state stays float64."""
    from p_a_multigrids_tpu_torch.ops.fused import to_t
    n1, n2 = K.KERNEL.launches, spmv.KERNEL.launches
    if kw == "mode10":
        gpu, cpu = _mode10(cuda, "float64"), _mode10("cpu", "float64")
        T = cpu.initial_condition()
        got, want = gpu._step(T.to(cuda)), cpu._step(T)
    else:
        cfg = SemiConfig(**{**dict(n_split=2, multi_levels=2, dt=0.05,
                                   dtype="float64"), **kw})
        mesh = structured.tri_mesh(12, 10, 1 / 12, 1 / 10)
        gpu, cpu = (semi.SemiSolver(semi.build_problem(mesh, cfg), d)
                    for d in (cuda, "cpu"))
        T_t = to_t(cpu.initial_condition())
        got, want = gpu._step_t(T_t.to(cuda)), cpu._step_t(T_t)
        if kw:
            assert gpu.krylov_iters == cpu.krylov_iters
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float64
    assert (K.KERNEL.launches > n1) == (kw != "mode10")
    assert (spmv.KERNEL.launches > n2) == bool(kw)
    assert float((got.cpu() - want).abs().max()) <= 1e-10 * float(
        want.abs().max())


def test_bicgstab_step_on_the_card_matches_cpu(cuda):
    """A V-cycle-preconditioned BiCGStab step (advection, --krylov) on the
    card against the same step on the CPU, both float32: iteration counts
    within one (f32 evaluation order at the stop), states within 1e-4 of
    the largest value."""
    from p_a_multigrids_tpu_torch.config import Physics
    from p_a_multigrids_tpu_torch.ops.fused import to_t
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.01, krylov=True,
                     krylov_tol=1e-6,
                     physics=Physics(advection=True, u=(1.0, 0.5)))
    mesh = structured.tri_mesh(12, 10, 1 / 12, 1 / 10)
    gpu, cpu = (semi.SemiSolver(semi.build_problem(mesh, cfg), d)
                for d in (cuda, "cpu"))
    T_t = to_t(cpu.initial_condition())
    n0 = K.KERNEL.launches
    got = gpu._step_t(T_t.to(cuda))
    torch.cuda.synchronize()
    assert K.KERNEL.launches > n0
    want = cpu._step_t(T_t)
    assert gpu.krylov_iters[0] > 2
    assert abs(gpu.krylov_iters[0] - cpu.krylov_iters[0]) <= 1
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.parametrize("solver", ["jacobi", "gauss_seidel"])
def test_point_smoother_step_on_the_card_matches_cpu(cuda, solver):
    """A V-cycle step with point Jacobi or colored Gauss-Seidel smoothing
    on the card (each operator apply one zero-round K1 launch: n_smooth
    a pre- and post-smoothing, two for GS, plus the residual) against the
    same step on the CPU, both float32: 1e-4 of the largest value."""
    from p_a_multigrids_tpu_torch.config import Solver
    from p_a_multigrids_tpu_torch.ops.fused import to_t
    cfg = SemiConfig(n_split=2, multi_levels=2, dt=0.05, n_multigrid=1,
                     solver=Solver(solver), omega=0.5)
    mesh = structured.tri_mesh(12, 10, 1 / 12, 1 / 10)
    gpu, cpu = (semi.SemiSolver(semi.build_problem(mesh, cfg), d)
                for d in (cuda, "cpu"))
    assert gpu.stencil and not gpu.phase_cycle
    T_t = to_t(cpu.initial_condition())
    n0, r0 = K.KERNEL.launches, K.KERNEL.rounds
    got = gpu._step_t(T_t.to(cuda))
    torch.cuda.synchronize()
    # level 0: 2 * n_smooth sweeps and the residual; level 1 is the dense
    # coarse solve
    applies = 2 * cfg.n_smooth * (2 if solver == "gauss_seidel" else 1) + 1
    assert K.KERNEL.launches - n0 == applies
    assert K.KERNEL.rounds - r0 == applies       # zero-round: the z round
    want = cpu._step_t(T_t)
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


def test_mode1_step_on_the_card_matches_cpu(cuda):
    """Mode 1's step (plain PyTorch, no kernel) on the card against the
    CPU, both float32, from the initial box: 1e-5 of the largest value."""
    from p_a_multigrids_tpu_torch.config import RectConfig
    from p_a_multigrids_tpu_torch.models import transport_rect
    cfg = RectConfig(no_ele_row=40, no_ele_col=8)
    out = []
    for dev in (cuda, "cpu"):
        problem = transport_rect.build_problem(cfg, dev)
        step, _ = transport_rect.make_step(problem)
        T = transport_rect.initial_condition(problem)
        for _ in range(5):
            T = step(T)
        out.append(T.cpu())
    assert float((out[0] - out[1]).abs().max()) <= 1e-5 * float(
        out[1].abs().max())


def test_entry_points_default_to_the_card(cuda):
    """Mode 1's build_problem and FusedOperator, given no device, put
    every tensor on the card."""
    from p_a_multigrids_tpu_torch.config import RectConfig
    from p_a_multigrids_tpu_torch.models import transport_rect
    from p_a_multigrids_tpu_torch.ops.fused import FusedOperator
    problem = transport_rect.build_problem(RectConfig(no_ele_row=40,
                                                      no_ele_col=8))
    assert {t.device.type for t in problem.tables.values()} == {"cuda"}
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05)
    L = semi.build_problem(structured.tri_mesh(4, 4, 0.25, 0.25),
                           cfg).levels[0]
    op = FusedOperator(L, cfg.physics, cfg.dt, cfg.theta)
    assert {b.device.type for b in op.buffers()} == {"cuda"}


# -- the checked builds (--debug): utils/debugging, csrc/checked.cuh --------

def _checked(op, san=None):
    """op with a sanitizer site (a fresh sanitizer unless given): its
    launches go to the checked build."""
    from p_a_multigrids_tpu_torch.utils import debugging
    san = san or debugging.Sanitizer(op.vals_t.device if hasattr(op, "vals_t")
                                     else op.Fp_t.device)
    op.sanitizer = san.site("test operator", getattr(op, "U", 0))
    return san


@pytest.mark.parametrize("tier", [None, "small", "resident", "stream"])
def test_checked_k1_is_bit_identical(cuda, tier):
    """The checked build of K1 gives the unchecked build's bits in every
    tier (the same plan, the same arithmetic), counts its launches on its
    own instance, and leaves the error record clean."""
    big = tier not in (None, "small")
    op, cheb, x, b = _k1_level(3 if big else 2, cuda,
                               (12, 10, 1 / 12, 0.1) if big else
                               (6, 5, 0.2, 0.25))
    runs = []
    for checked in (False, True):
        san = _checked(op) if checked else None
        if not checked:
            op.sanitizer = None
        n0, c0 = K.KERNEL.launches, K.CHECKED.launches
        out = K.phase_on_tier(op, x, op._bp(b, True), cheb, True, tier)
        torch.cuda.synchronize()
        assert (K.CHECKED.launches - c0, K.KERNEL.launches - n0) == (
            (1, 0) if checked else (0, 1))
        runs.append(out)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert K.CHECKED.plan(op, tier) == K.KERNEL.plan(op, tier)
    san.raise_on_fault()


@pytest.mark.parametrize("tier", ["small", "resident", "stream"])
def test_checked_k1_float64_is_bit_identical(cuda, tier):
    """The checked build of K1 in float64 gives the unchecked build's bits
    in each tier, with a clean error record."""
    op, cheb, x, b = _k1_f64_level(tier, cuda)
    runs = []
    for checked in (False, True):
        san = _checked(op) if checked else None
        if not checked:
            op.sanitizer = None
        c0 = K.CHECKED.launches
        runs.append(K.phase(op, x, op._bp(b, True), cheb, True))
        torch.cuda.synchronize()
        assert K.CHECKED.launches - c0 == int(checked)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert K.CHECKED.plan(op).tier == tier
    san.raise_on_fault()


@pytest.mark.parametrize("variant", ["thread", "lanes"])
def test_checked_k2_float64_is_bit_identical(cuda, variant):
    rng = np.random.default_rng(6)
    op = spmv.RowOp(rng.integers(0, 700, size=(500, 27)),
                    rng.normal(size=(500, 27, 3, 3)), 700, torch.float64,
                    cuda, variant)
    x = torch.tensor(rng.normal(size=(3, 700)), dtype=torch.float64,
                     device=cuda)
    plain = op(x)
    san = _checked(op)
    c0 = spmv.CHECKED.launches
    got = op(x)
    torch.cuda.synchronize()
    assert spmv.CHECKED.launches - c0 == 1
    assert torch.equal(got, plain)
    san.raise_on_fault()


def test_checked_kernel_float64_nonfinite_raises(cuda):
    """A float64 non-finite value is recorded as a float32 Inf / NaN and
    raises FloatingPointError naming it."""
    op, cheb, x, b = _k1_f64_level("small", cuda)
    op.Fp_t.view(-1)[0] = float("inf")
    san = _checked(op)
    K.phase(op, x, op._bp(b, True), cheb, True)
    with pytest.raises(FloatingPointError, match=r"wrote (inf|nan|-inf)"):
        san.raise_on_fault()


def test_checked_k2_is_bit_identical(cuda):
    """Every rowop of an SA hierarchy, both variants, checked == unchecked
    bit for bit."""
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05)
    mesh = structured.tri_mesh(12, 10, 1 / 12, 1 / 10)
    L = semi.build_problem(mesh, cfg).levels[0]
    data = stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    h = agg.AggHierarchy(agg.build_hierarchy(
        data, splitting.child_coords(mesh.X, 2), max_dense_dof=256,
        strength=0.5, always=True), torch.float32, cuda)
    rng = np.random.default_rng(2)
    for op in h.rowops().values():
        x = torch.tensor(rng.normal(size=(3, op.n_src)),
                         dtype=torch.float32, device=cuda)
        plain = op(x)
        san = _checked(op)
        c0 = spmv.CHECKED.launches
        got = op(x)
        torch.cuda.synchronize()
        assert spmv.CHECKED.launches - c0 == 1
        assert torch.equal(got, plain)
        san.raise_on_fault()


def _debug_pair(cuda, **kw):
    cfg = SemiConfig(**{**dict(n_split=2, multi_levels=2, dt=0.05,
                                ntime=2), **kw})
    mesh = structured.tri_mesh(12, 10, 1 / 12, 1 / 10)
    problem = semi.build_problem(mesh, cfg)
    import dataclasses
    plain = semi.SemiSolver(problem, cuda)
    dbg = semi.SemiSolver(dataclasses.replace(
        problem, cfg=dataclasses.replace(cfg, debug=True)), cuda)
    return plain, dbg


@pytest.mark.parametrize("kw", [{}, {"amg": True, "multi_levels": 1,
                                     "krylov": True},
                                {"amg": True, "multi_levels": 1,
                                 "krylov": True, "dtype": "float64"}],
                         ids=["geometric", "amg_krylov", "amg_krylov_f64"])
def test_checked_step_is_bit_identical(cuda, kw):
    """A clean checked run on the card gives the unchecked run's bits, with
    as many checked launches as the unchecked run makes."""
    plain, dbg = _debug_pair(cuda, **kw)
    counts = []
    outs = []
    for sv, k1, k2 in ((plain, K.KERNEL, spmv.KERNEL),
                       (dbg, K.CHECKED, spmv.CHECKED)):
        n1, n2 = k1.launches, k2.launches
        outs.append(sv.run())
        torch.cuda.synchronize()
        counts.append((k1.launches - n1, k2.launches - n2))
    assert torch.equal(outs[0], outs[1])
    assert counts[0] == counts[1] and counts[0][0] > 0
    if kw:
        assert counts[0][1] > 0


@pytest.mark.parametrize("table", ["src_cu", "intra_rows", "slot_idx",
                                   "cols_t"])
def test_checked_kernel_index_fault_raises(cuda, table):
    """One index set out of range by hand after the solver was built (so
    no host check sees it) raises IndexError from the checked kernel's
    error record at the end of the step."""
    _, dbg = _debug_pair(cuda, amg=True, multi_levels=1)
    if table == "cols_t":
        op = dbg.agg.levels[0].op
        op.cols_t.view(-1)[5] = op.n_src + 3
        match = r"K2 .*cols .*outside \[0, "
    else:
        op = dbg.ops[0]
        bound = {"src_cu": op.C * op.U, "intra_rows": op.C,
                 "slot_idx": op.nb}[table]
        getattr(op, table).view(-1)[1] = bound + 7
        match = r"K1 .*level 0 .*outside \[0, "
    with pytest.raises(IndexError, match=match + ".*error record"):
        dbg.run(ntime=1)


def test_checked_kernel_nonfinite_raises(cuda):
    """An infinite coefficient makes K1 write a non-finite value: the
    checked build records it; a NaN state raises before the kernels."""
    _, dbg = _debug_pair(cuda)
    T0 = dbg.initial_condition()
    bad = T0.clone()
    bad[0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="state before the step"):
        dbg.run(bad, ntime=1)
    dbg.ops[0].Fp_t.view(-1)[0] = float("inf")
    with pytest.raises(FloatingPointError, match=r"K1 .*level 0 .*error "
                       r"record"):
        dbg.run(T0, ntime=1)


# -- the distributed solver (parallel/) on the card ----------------------------

DIST_CASE = dict(id="geo", kind="stencil", mesh=[16, 4, 0.25, 0.25],
                 cfg=dict(n_split=2, multi_levels=2, dt=0.05, ntime=2,
                          n_multigrid=2), ntime=2, serial=True)


@pytest.mark.parametrize("ranks", [1, 2])
def test_distributed_on_the_card_equals_serial(cuda, ranks):
    """1 rank (nccl: one card a rank) and 2 ranks sharing the card (gloo,
    messages staged through host memory): two geometric steps equal the
    serial solver's on the card bit for bit, the ranks' K1 phases on their
    extended domains included."""
    from p_a_multigrids_tpu_torch.parallel import cases, comm

    backend = comm.backend_for(cuda, ranks)
    assert backend == ("nccl" if ranks <= torch.cuda.device_count()
                       else "gloo")
    r = comm.launch(cases.run_cases, ranks, cuda, args=([DIST_CASE],),
                    timeout=300)[0]["geo"]
    np.testing.assert_array_equal(r["std"], r["serial"])
    assert r["k1"] > 0


def test_bench_dist_retention_on_the_card(cuda, monkeypatch, capsys):
    """The distributed bench's retention section at a small size, one rank
    under nccl: K1 ran every distributed cycle (K2 with amg), the geometric
    state equals the serial twin's bit for bit, amg within float32
    summation order, and the line carries the card's name."""
    from p_a_multigrids_tpu_torch import bench_dist

    monkeypatch.setattr(bench_dist, "DIST8_MESH", (16, 4, 0.25, 0.25))
    monkeypatch.setattr(bench_dist, "RETENTION_CYCLES", 2)
    monkeypatch.setattr(bench_dist, "REPS", 1)
    assert bench_dist.main(["--devices", "1", "--section", "retention"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert (line["backend"], line["ranks_per_card"]) == ("nccl", 1)
    assert line["device"][0].startswith(torch.cuda.get_device_name(0))
    for name, r in line["retention"]["configs"].items():
        assert r["k1_phase_dist"] and r["launches"]["k1_phase"][0] > 0
        assert (r["launches"]["k2_rowop"][0] > 0) == r["amg_tables_built"]
        assert r["dist_vs_serial_rel"] <= (0.0 if name == "geometric"
                                           else 1e-5)
        assert r["retention_factor"] > 0


@pytest.mark.parametrize("kw", [{}, {"amg": True, "multi_levels": 1,
                                     "krylov": True}],
                         ids=["geometric", "amg_krylov"])
def test_distributed_float64_on_the_card(cuda, kw):
    """2 ranks sharing the card in float64: K1 (and K2 with amg) launch on
    the ranks, the state stays float64, the geometric steps equal the
    serial solver's bit for bit and the amg PCG steps agree with it to
    1e-9 of the largest value."""
    from p_a_multigrids_tpu_torch.parallel import cases, comm

    case = dict(DIST_CASE, cfg=dict(DIST_CASE["cfg"], dtype="float64", **kw))
    r = comm.launch(cases.run_cases, 2, cuda, args=([case],),
                    timeout=300)[0]["geo"]
    assert r["std"].dtype == np.float64 and r["k1"] > 0
    assert (r["k2"] > 0) == bool(kw)
    if kw:
        assert r["krylov_iters"] == r["serial_krylov_iters"]
        np.testing.assert_allclose(r["std"], r["serial"], rtol=0,
                                   atol=1e-9 * np.abs(r["serial"]).max())
    else:
        np.testing.assert_array_equal(r["std"], r["serial"])


def test_k1_on_an_extended_domain_matches_plain(cuda):
    """K1 on a rank's extended-domain operator (4 ranks, rank 1, the final
    and the mid geometry of a chunked phase) against phase_reference."""
    from p_a_multigrids_tpu_torch.parallel import stencil_solver as ss

    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05)
    L = semi.build_problem(structured.tri_mesh(16, 4, 0.25, 0.25),
                           cfg).levels[0]
    data = stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    U, C = data.self_blocks.shape[:2]
    W, U_loc = ss.band(data), U // 4
    rng = np.random.default_rng(1)
    for H, rounds in ((2 * W, 1), (W, 1)):
        op = stencil.StencilOperator(
            ss._ext_data(data, U, C, U_loc - H, U_loc + 2 * H),
            torch.float32, cuda)
        x, bp = (torch.tensor(rng.normal(size=(3, C, op.U)),
                              dtype=torch.float32, device=cuda)
                 for _ in range(2))
        _k1_matches_plain(op, x, bp, [0.7] * rounds, H == 2 * W, 1e-4)


@pytest.mark.parametrize("method", ["chebyshev", "jacobi"])
def test_stencil_smoothing_is_one_k1_phase(cuda, method):
    """StencilOperator.smooth_chebyshev / smooth_jacobi on the card: one K1
    launch, against the same rounds of phase_reference (1e-4 relative, as
    a multi-round phase above)."""
    op, cheb, x, b = _k1_level(2, cuda)
    roots = [1.0 / c for c in cheb]
    n0 = K.KERNEL.launches
    if method == "chebyshev":
        got = op.smooth_chebyshev(x, b, roots, 1, True)
        coefs = [1.0 / r for r in roots]
    else:
        got = op.smooth_jacobi(x, b, 0.8, 3, True)
        coefs = [0.8] * 3
    torch.cuda.synchronize()
    assert K.KERNEL.launches - n0 == 1
    want, _ = K.phase_reference(op, x, op._bp(b, True), coefs, False)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_bsr_spmv_is_one_k2_launch(cuda):
    """BSR.spmv of mode 10's assembled operator on the card: one K2 launch,
    equal to the CPU's spmv within 1e-5 of the largest value."""
    from p_a_multigrids_tpu_torch.models import semi_assembled
    cfg = SemiConfig(n_split=2, multi_levels=1, dt=0.05)
    L = semi.build_problem(structured.tri_mesh(12, 10, 1 / 12, 1 / 10),
                           cfg).levels[0]
    A = semi_assembled.assemble_operator(L, cfg.physics, cfg.dt, cfg.theta)
    x = torch.tensor(np.random.default_rng(8).normal(size=(A.num_rows, 3)),
                     dtype=torch.float32)
    n0 = spmv.KERNEL.launches
    got = A.spmv(x.to(cuda))
    torch.cuda.synchronize()
    assert spmv.KERNEL.launches - n0 == 1
    want = A.spmv(x)
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_trace_holds_every_launch(cuda, tmp_path):
    """utils.profiling.trace of a short block of K1 phases launched at
    once, three times: each trace opens with its one-element int8 fills
    and holds every launch the wrapper counted."""
    from p_a_multigrids_tpu_torch.utils import profiling
    op, cheb, x, b = _k1_level(2, cuda)
    bp = op._bp(b, True)
    K.phase(op, x, bp, cheb, True)
    torch.cuda.synchronize()
    for i in range(3):
        n0 = K.KERNEL.launches
        with profiling.trace(str(tmp_path / str(i))) as path:
            for _ in range(5):
                K.phase(op, x, bp, cheb, True)
        counted = K.KERNEL.launches - n0
        kernels = profiling.trace_kernels(path)
        first = min(kernels, key=lambda k: k[1])[0]
        assert counted == 5 and profiling.PRIME_KERNEL in first
        assert profiling._missing_launches(
            kernels, {"k1_phase": counted, "k2_rowop": 0}) is None


def test_tune_amg_case_on_the_card(cuda, monkeypatch, capsys):
    """The knob sweep's agg_target=8 case at a small size: K1 and K2 ran,
    rho in (0, 1), the line names the card."""
    from p_a_multigrids_tpu_torch import bench, tune_amg
    monkeypatch.setattr(bench, "BENCH_MESH", (16, 8, 1 / 16, 1 / 8))
    monkeypatch.setattr(tune_amg, "CASES", tune_amg.CASES[5:6])
    assert tune_amg.main([]) == 0
    out = json.loads(capsys.readouterr().out)
    (row,) = out["cases"]
    assert row["name"] == "deg16-sw1-t8" and 0 < row["rho"] < 1
    assert row["launches"]["k1_phase"] > 0 and row["launches"]["k2_rowop"] > 0
    assert out["extra"]["device"].startswith(torch.cuda.get_device_name(0))
    assert out["extra"]["ndof"] == 256 * 16 * 3


# the benchmark's spans (pamg_bench/system.py) and the program's own
# (utils.tracing) that own the same kernels; the benchmark's "step" is the
# step and the residual read, the program's "pamg.step" and
# "pamg.residual"
PROGRAM_SPANS = {"k1": "pamg.k1", "k2": "pamg.k2", "rhs": "pamg.rhs",
                 "krylov": "pamg.krylov"}


@pytest.mark.parametrize("workload", ["tri8192_ns2.amg_pcg",
                                      "tri8192_ns2.geo_vcycle"])
def test_program_spans_own_the_benchmarks_kernels(cuda, workload):
    """One traced window of each benchmark cell's solver, at its size:
    every K1 launch lies inside a ``pamg.k1`` range (launched one by one)
    or, in the bare geometric step, a ``pamg.step.graph`` range (replayed
    from the step's graph; ``pamg.vcycle.l<i>`` and ``pamg.k1`` fire
    there only in the capturing step, in the warm-up), every K2 launch
    inside a ``pamg.k2`` range or a ``pamg.sa.graph`` range (replayed
    from the SA cycle's graph), and each of the program's spans owns
    exactly the kernels that the benchmark's span of the same layer owns
    (``yardstick.read_window`` over the same events)."""
    import pathlib

    from pamg_bench import run, spec, system, yardstick
    root = pathlib.Path(__file__).resolve().parents[1]
    cell = spec.load_cell(root, workload, True)
    solver = system.build(cell, cuda)
    st = solver.stepper()
    tr = run.Traffic(cell, solver, 2 ** 31 + 12345, cuda)
    rec = system.Recorder(spans=True)
    names = system.SPANS + tuple(PROGRAM_SPANS.values()) + (
        "pamg.step", "pamg.residual", agg.GRAPH_SPAN, semi.STEP_GRAPH.span)
    with rec:
        rec.count_rowops(solver)
        S = run.run_steps(st, tr, rec, None,
                          int(cell.traffic["warmup_steps"]), None, [], [])
        for _ in range(5):
            events, launched = yardstick.trace_window(
                lambda: run.run_steps(st, tr, rec, S, 5, None, [], []),
                system.launch_counts)
            ks, _ = yardstick.read_window(events, names)
            if yardstick.missing_launches(ks, launched) is None:
                break
        else:
            pytest.fail(yardstick.missing_launches(ks, launched))
    assert launched["k1_phase"] > 0
    assert (launched["k2_rowop"] > 0) == ("amg" in workload)
    for k in ks:
        if k["cls"] == "k1_phase":
            assert ("pamg.k1" in k["spans"]) != (
                semi.STEP_GRAPH.span in k["spans"]), k["name"]
        if k["cls"] == "k2_rowop":
            assert ("pamg.k2" in k["spans"]) != (
                agg.GRAPH_SPAN in k["spans"]), k["name"]

    def owned(*spans):
        return [i for i, k in enumerate(ks) if set(spans) & k["spans"]]

    if "amg" in workload:
        assert owned("pamg.k2") and owned(agg.GRAPH_SPAN)
        assert not owned(semi.STEP_GRAPH.span)
    else:
        assert owned("pamg.k1") and owned(semi.STEP_GRAPH.span)

    for bench, program in PROGRAM_SPANS.items():
        assert owned(bench) == owned(program), bench
    assert owned("step") == owned("pamg.step", "pamg.residual")
    assert not [k for k in ks if {"pamg.step", "pamg.residual"} <= k["spans"]]


@pytest.fixture(scope="module")
def amg_cell_solver():
    """The benchmark's ``tri8192_ns2.amg_pcg`` solver, at its size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SA cycle's graph runs only "
                    "on the GPU")
    import pathlib

    from pamg_bench import spec, system
    root = pathlib.Path(__file__).resolve().parents[1]
    cell = spec.load_cell(root, "tri8192_ns2.amg_pcg")
    return system.build(cell, torch.device("cuda"))


def _cell_hierarchy(solver, dtype):
    """A fresh device hierarchy of the cell's SA tables in ``dtype``, with
    three seeded right-hand sides of its level 0."""
    h = agg.AggHierarchy(solver._agg_host, dtype, solver.device)
    rng = np.random.default_rng(7)
    rcs = [torch.tensor(rng.normal(size=(3, h.levels[0].n)), dtype=dtype,
                        device=solver.device) for _ in range(3)]
    return h, rcs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sa_graph_replay_is_bit_identical(amg_cell_solver, dtype):
    """``vcycle_iter`` on the card == the eager cycles, bit for bit: the
    first call (it captures the graph) and three replays of the one graph,
    whose static input each right-hand side reuses."""
    h, rcs = _cell_hierarchy(amg_cell_solver, dtype)
    for rc in rcs[:1] + rcs:
        want = agg._vcycle_iter(h, rc, 1)
        got = agg.vcycle_iter(h, rc, 1).clone()
        assert torch.equal(got, want)
    (graph,) = h.graphs.values()
    assert len(graph.xs) == 1 and torch.equal(graph.xs[0], rcs[-1])


def test_sa_graph_counts_what_ran(amg_cell_solver):
    """Capturing launches nothing: the first call counts its eager run's
    22 K2 launches, as each of N replays does; the counters count one
    capture, N replays, and N times the replay's K2 launches and their
    least bytes, those of the operators the eager run applied."""
    from p_a_multigrids_tpu_torch.utils import profiling, tracing
    h, rcs = _cell_hierarchy(amg_cell_solver, torch.float32)
    applied = []
    hooks = [op.register_forward_pre_hook(lambda m, _: applied.append(m))
             for op in h.rowops().values()]
    n0 = spmv.KERNEL.launches
    agg._vcycle_iter(h, rcs[0], 1)
    eager = spmv.KERNEL.launches - n0
    for hook in hooks:
        hook.remove()
    assert eager == 22 == len(applied)
    c0 = dict(tracing.snapshot()["counters"])
    n0, ch0 = spmv.KERNEL.launches, spmv.CHECKED.launches
    graph, _ = agg._capture(h, rcs[0], 1)
    torch.cuda.synchronize()
    assert spmv.KERNEL.launches - n0 == eager
    assert graph.launched == {"k2": ({"launches": eager}, {"launches": 0})}
    assert graph.launches("k2") == eager
    assert graph.least_bytes == sum(profiling.rowop_least_bytes(op)
                                    for op in applied)
    for rc in rcs:
        graph(rc)
    torch.cuda.synchronize()
    assert spmv.KERNEL.launches - n0 == eager + len(rcs) * eager
    assert spmv.CHECKED.launches == ch0
    c1 = tracing.snapshot()["counters"]
    assert c1.get("sa_graph_captures", 0) - c0.get("sa_graph_captures",
                                                     0) == 1
    assert c1["sa_graph_replays"] - c0.get("sa_graph_replays", 0) == len(rcs)
    assert (c1["sa_graph_k2_launches"] - c0.get("sa_graph_k2_launches", 0)
            == len(rcs) * eager)
    assert (c1["sa_graph_k2_least_bytes"]
            - c0.get("sa_graph_k2_least_bytes", 0)
            == len(rcs) * graph.least_bytes)


def test_sa_graph_follows_the_sanitizer(amg_cell_solver):
    """Sites given to the cycle's operators after a capture (a solver made
    checked after it ran) make the next call capture the checked build
    in the unchecked graph's place: its launches are all checked, its
    bits the unchecked graph's; with the sites taken off again the next
    call captures the unchecked build once more, in the checked graph's
    place."""
    from p_a_multigrids_tpu_torch.utils import debugging
    h, rcs = _cell_hierarchy(amg_cell_solver, torch.float32)
    want = agg.vcycle_iter(h, rcs[0], 1).clone()
    san = debugging.Sanitizer(rcs[0].device)
    ops = list(h.rowops().values())
    for i, op in enumerate(ops):
        op.sanitizer = san.site(f"rowop {i}")
    n0, c0 = spmv.KERNEL.launches, spmv.CHECKED.launches
    for _ in range(2):
        assert torch.equal(agg.vcycle_iter(h, rcs[0], 1), want)
    torch.cuda.synchronize()
    assert spmv.KERNEL.launches == n0
    assert spmv.CHECKED.launches - c0 == 2 * 22
    san.raise_on_fault()
    for op in ops:
        op.sanitizer = None
    assert torch.equal(agg.vcycle_iter(h, rcs[0], 1), want)
    assert spmv.KERNEL.launches - n0 == 22
    (graph,) = h.graphs.values()
    assert all(site is None for site in graph.sites)


def test_sa_graph_replays_are_traced(amg_cell_solver):
    """One traced window of replays, read as the benchmark reads it: the
    trace holds every replayed K2 launch the counter counted, each inside
    a ``pamg.sa.graph`` range, and ``k2_graph_hbm_roofline_share`` reads
    them at under 105% of the roofline."""
    from p_a_multigrids_tpu_torch.utils import tracing
    from pamg_bench import spec, system, yardstick
    h, rcs = _cell_hierarchy(amg_cell_solver, torch.float32)
    agg.vcycle_iter(h, rcs[0], 1)
    torch.cuda.synchronize()

    def window():
        for rc in rcs:
            agg.vcycle_iter(h, rc, 1)

    for _ in range(5):
        tracing.reset()
        events, launched = yardstick.trace_window(window,
                                                  system.launch_counts)
        ks, _ = yardstick.read_window(events, (agg.GRAPH_SPAN,))
        if yardstick.missing_launches(ks, launched) is None:
            break
    else:
        pytest.fail(yardstick.missing_launches(ks, launched))
    assert launched == {"k1_phase": 0, "k2_rowop": 22 * len(rcs)}
    k2 = [k for k in ks if k["cls"] == "k2_rowop"]
    assert len(k2) == 22 * len(rcs)
    assert all(agg.GRAPH_SPAN in k["spans"] for k in k2)
    share = spec.load_metric("k2_graph_hbm_roofline_share").read(
        {"kernels": ks})
    assert 0 < share <= 105


@pytest.fixture(scope="module")
def sweep_cell_solvers():
    """The benchmark's ``sweep98304_ns5.w6_pcg`` solver at its size, in
    its float32 and in float64, by dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the geometric preconditioner's "
                    "graph runs only on the GPU")
    import pathlib

    from pamg_bench import spec
    root = pathlib.Path(__file__).resolve().parents[1]
    cell = spec.load_cell(root, "sweep98304_ns5.w6_pcg")
    mesh = structured.tri_mesh(*cell.config["mesh"]["tri_mesh"])
    out = {}
    for dtype in (torch.float32, torch.float64):
        cfg = SemiConfig(**{**cell.semi_fields(),
                            "dtype": str(dtype).split(".")[1]})
        out[dtype] = semi.SemiSolver(semi.build_problem(mesh, cfg),
                                     torch.device("cuda"))
    return out


def _sweep_rhs(solver, n=3):
    """The solver with no graph yet, and n seeded right-hand sides of its
    finest level."""
    solver._graphs.clear()
    op = solver.ops[0]
    rng = np.random.default_rng(11)
    return [torch.tensor(rng.normal(size=(3, op.C, op.U)),
                         dtype=solver.dtype, device=solver.device)
            for _ in range(n)]


def _eager_cycle(solver, r):
    return solver._vcycle_t(0, torch.zeros_like(r), r, hom=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mg_graph_replay_is_bit_identical(sweep_cell_solvers, dtype):
    """The preconditioner on the card == the eager W-cycle, bit for bit:
    the first call (it captures the graph) and three replays of the one
    graph, each handing back a copy that the next replay leaves alone."""
    solver = sweep_cell_solvers[dtype]
    rs = _sweep_rhs(solver)
    got = []
    for r in rs[:1] + rs:
        got.append(solver._precond_t(r))
        assert torch.equal(got[-1], _eager_cycle(solver, r))
    (graph,) = solver._graphs.values()
    assert graph.kind is semi.MG_GRAPH
    assert len(graph.xs) == 1 and torch.equal(graph.xs[0], rs[-1])
    for g, r in zip(got[1:], rs):
        assert g.data_ptr() != graph.y.data_ptr()
        assert torch.equal(g, _eager_cycle(solver, r))


def test_mg_graph_pcg_equals_the_eager_solve(sweep_cell_solvers,
                                             monkeypatch):
    """A PCG solve of the cell's step through the graph == the same solve
    with the eager preconditioner: the same iterate bit for bit, the same
    iterations and host syncs (PCG keeps z as its search direction across
    the next preconditioner call, so a replay that handed back its static
    output would change the iterate)."""
    from p_a_multigrids_tpu_torch.utils import tracing
    solver = sweep_cell_solvers[torch.float32]
    _sweep_rhs(solver)
    st = solver.stepper()
    rng = np.random.default_rng(12)
    T = solver.initial_condition()
    S = st.to_state(T + torch.as_tensor(rng.normal(size=T.shape),
                                        dtype=T.dtype, device=T.device))
    st.step(S)                                 # captures the graph
    runs = []
    for eager in (False, True):
        if eager:
            monkeypatch.setattr(solver, "_precond_t",
                                lambda r: _eager_cycle(solver, r))
        c0 = tracing.snapshot()["counters"]
        x = st.step(S)
        c1 = tracing.snapshot()["counters"]
        runs.append((x, solver.krylov_iters[-1],
                     c1["host_syncs"] - c0["host_syncs"],
                     c1.get("mg_graph_replays", 0)
                     - c0.get("mg_graph_replays", 0)))
    (x_g, its_g, syncs_g, replays_g), (x_e, its_e, syncs_e, replays_e) = runs
    assert torch.equal(x_g, x_e)
    assert its_g == its_e > 1 and syncs_g == syncs_e == 2 * its_g + 1
    assert replays_g == its_g + 1 and replays_e == 0


def test_mg_graph_counts_what_ran(sweep_cell_solvers):
    """The capturing call counts one eager cycle's K1 launches, rounds,
    tiers and deep launches and its 30 transfer launches (2 a visit of
    each of the W-cycle's 15 non-coarsest level visits), as each of N
    replays does; the counters count one capture, N replays, and N times
    the replay's K1 launches (30, K1's alone), the least bytes of the
    cycle's K1 calls, as ``utils.profiling.least_bytes`` reckons an eager
    call's, and its transfer launches."""
    from p_a_multigrids_tpu_torch.utils import tracing

    def counts():
        return {"launches": K.KERNEL.launches, "rounds": K.KERNEL.rounds,
                "deep": K.KERNEL.launches_deep, "checked": K.CHECKED.launches,
                "transfer": transfer.KERNEL.launches,
                **{f"transfer_{e}": n
                   for e, n in transfer.KERNEL.by_entry.items()},
                **{f"tier_{t}": n for t, n in K.KERNEL.by_tier.items()}}

    def grown(a, b):
        return {k: b[k] - a[k] for k in a}

    solver = sweep_cell_solvers[torch.float32]
    rs = _sweep_rhs(solver)
    n0 = counts()
    with K.watch() as calls:
        _eager_cycle(solver, rs[0])
    eager = grown(n0, counts())
    assert eager["launches"] == len(calls) == 30
    assert eager["transfer"] == 2 * 15
    assert eager["transfer_restrict"] == eager["transfer_prolong_add"] == 15
    assert eager["deep"] > 0 and eager["tier_small"] > 0
    assert eager["checked"] == 0
    c0 = dict(tracing.snapshot()["counters"])
    n0 = counts()
    solver._precond_t(rs[0])
    torch.cuda.synchronize()
    assert grown(n0, counts()) == eager
    (graph,) = solver._graphs.values()
    assert graph.launches("k1") == eager["launches"]
    assert graph.launches("transfer") == eager["transfer"]
    assert graph.least_bytes == sum(calls)
    for r in rs:
        solver._precond_t(r)
    torch.cuda.synchronize()
    assert grown(n0, counts()) == {k: (len(rs) + 1) * v
                                   for k, v in eager.items()}
    c1 = tracing.snapshot()["counters"]

    def added(name):
        return c1.get(name, 0) - c0.get(name, 0)

    assert added("mg_graph_captures") == 1
    assert added("mg_graph_replays") == len(rs)
    assert added("mg_graph_k1_launches") == len(rs) * eager["launches"]
    assert added("mg_graph_k1_least_bytes") == len(rs) * sum(calls)
    assert added("mg_graph_transfer_launches") == len(rs) * eager["transfer"]
    assert (tracing.snapshot()["kernels"]["transfer"]
            == transfer.KERNEL.launches)


@pytest.fixture(scope="module")
def streaming_solver():
    """The benchmark's ``scale589824_ns7.v8_pcg`` configuration (n_split
    7, 8 levels, float32) on 12 of its 36 macros: 196,608 (child, macro)
    pairs at the finest level, more than K1's resident tier holds on an
    H100, so that level streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the geometric preconditioner's "
                    "graph runs only on the GPU")
    import pathlib

    from pamg_bench import spec
    root = pathlib.Path(__file__).resolve().parents[1]
    cell = spec.load_cell(root, "scale589824_ns7.v8_pcg")
    cfg = SemiConfig(**cell.semi_fields())
    return semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(3, 2, 1 / 6, 1 / 6), cfg), torch.device("cuda"))


def test_k1_bytes_by_tier_replay_equals_eager(streaming_solver):
    """K1's least bytes by tier (``KERNEL.least_bytes_by_tier``): an eager
    V-cycle of the n_split 7 hierarchy adds in each tier the least bytes
    of its launches there (``utils.profiling.least_bytes`` of each call:
    in the streaming tier the fine level's pre-smoothing phase with z and
    its post-smoothing phase); the call that captures the preconditioner's
    graph adds the same, and so does each replay, with the launches by
    tier."""
    from p_a_multigrids_tpu_torch.utils.profiling import least_bytes
    solver = streaming_solver
    op0 = solver.ops[0]
    assert K.KERNEL.plan(op0).tier == "stream"
    rs = _sweep_rhs(solver)

    def counts():
        return {**{f"launches_{t}": n for t, n in K.KERNEL.by_tier.items()},
                **{f"bytes_{t}": n
                   for t, n in K.KERNEL.least_bytes_by_tier.items()}}

    def grown(a, b):
        return {k: b[k] - a[k] for k in a}

    n0 = counts()
    with K.watch() as calls:
        _eager_cycle(solver, rs[0])
    eager = grown(n0, counts())
    assert eager["launches_stream"] == 2
    assert eager["bytes_stream"] == (least_bytes(op0, 4, 4)
                                     + least_bytes(op0, 4, 3))
    assert sum(eager[f"bytes_{t}"] for t in K.TIERS) == sum(calls)
    n0 = counts()
    solver._precond_t(rs[0])
    torch.cuda.synchronize()
    assert grown(n0, counts()) == eager
    n0 = counts()
    for r in rs:
        solver._precond_t(r)
    torch.cuda.synchronize()
    assert grown(n0, counts()) == {k: len(rs) * v for k, v in eager.items()}


def test_mg_graph_follows_the_sanitizer(sweep_cell_solvers):
    """Sites given to the levels' operators after a capture (a solver made
    checked after it ran) make the next call capture the checked K1 build
    in the unchecked graph's place: its launches are all checked, its
    bits the unchecked graph's; with the sites taken off again the next
    call captures the unchecked build once more."""
    from p_a_multigrids_tpu_torch.utils import debugging
    solver = sweep_cell_solvers[torch.float32]
    rs = _sweep_rhs(solver, 1)
    want = solver._precond_t(rs[0])
    (unchecked,) = solver._graphs.values()
    san = debugging.Sanitizer(solver.device)
    for i, op in enumerate(solver.ops):
        op.sanitizer = san.site(f"level {i}", op.U)
    try:
        n0, c0 = K.KERNEL.launches, K.CHECKED.launches
        for _ in range(2):
            assert torch.equal(solver._precond_t(rs[0]), want)
        torch.cuda.synchronize()
        assert K.KERNEL.launches == n0
        assert K.CHECKED.launches - c0 == 2 * unchecked.launches("k1")
        san.raise_on_fault()
        (checked,) = solver._graphs.values()
        assert (checked.launched["k1"][1]["launches"]
                == unchecked.launches("k1"))
    finally:
        for op in solver.ops:
            op.sanitizer = None
    assert torch.equal(solver._precond_t(rs[0]), want)
    assert K.KERNEL.launches - n0 == unchecked.launches("k1")
    (graph,) = solver._graphs.values()
    assert all(site is None for site in graph.sites)


def test_mg_graph_replays_are_traced(sweep_cell_solvers):
    """One traced window of replays, read as the benchmark reads it: the
    trace holds every replayed K1 launch the counter counted, each inside
    a ``pamg.mg.graph`` range and outside every ``pamg.k1`` range, and
    ``k1_graph_hbm_roofline_share`` reads them at under 105% of the
    roofline."""
    from p_a_multigrids_tpu_torch.utils import tracing
    from pamg_bench import spec, system, yardstick
    solver = sweep_cell_solvers[torch.float32]
    rs = _sweep_rhs(solver)
    solver._precond_t(rs[0])
    torch.cuda.synchronize()
    (graph,) = solver._graphs.values()
    span = semi.MG_GRAPH.span

    def window():
        for r in rs:
            solver._precond_t(r)

    for _ in range(5):
        tracing.reset()
        events, launched = yardstick.trace_window(window,
                                                  system.launch_counts)
        ks, _ = yardstick.read_window(events, ("pamg.k1", span))
        if yardstick.missing_launches(ks, launched) is None:
            break
    else:
        pytest.fail(yardstick.missing_launches(ks, launched))
    assert launched == {"k1_phase": graph.launches("k1") * len(rs),
                        "k2_rowop": 0}
    k1 = [k for k in ks if k["cls"] == "k1_phase"]
    assert len(k1) == graph.launches("k1") * len(rs)
    assert all(span in k["spans"] and "pamg.k1" not in k["spans"]
               for k in k1)
    share = spec.load_metric("k1_graph_hbm_roofline_share").read(
        {"kernels": ks})
    assert 0 < share <= 105


@pytest.fixture(scope="module")
def geo_cell_solvers():
    """The benchmark's ``tri8192_ns2.geo_vcycle`` solver at its size, in
    its float32 and in float64, by dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bare step's graph runs only "
                    "on the GPU")
    import pathlib

    from pamg_bench import spec
    root = pathlib.Path(__file__).resolve().parents[1]
    cell = spec.load_cell(root, "tri8192_ns2.geo_vcycle")
    mesh = structured.tri_mesh(*cell.config["mesh"]["tri_mesh"])
    out = {}
    for dtype in (torch.float32, torch.float64):
        cfg = SemiConfig(**{**cell.semi_fields(),
                            "dtype": str(dtype).split(".")[1]})
        out[dtype] = semi.SemiSolver(semi.build_problem(mesh, cfg),
                                     torch.device("cuda"))
    return out


def _geo_states(solver, n=3):
    """The solver with no graph yet, and n seeded states near its initial
    condition, transposed."""
    solver._graphs.clear()
    T = solver.initial_condition()
    rng = np.random.default_rng(13)
    return [semi.to_t(T + torch.as_tensor(0.1 * rng.normal(size=T.shape),
                                          dtype=T.dtype, device=T.device))
            for _ in range(n)]


def _eager_step(solver, T_t):
    """The bare step as it runs off the graph: the right-hand side, then
    ``n_multigrid`` cycles from T_t."""
    b_t = solver._rhs_t(T_t)
    for _ in range(solver.cfg.n_multigrid):
        T_t = solver._vcycle_t(0, T_t, b_t)
    return T_t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_graph_replay_is_bit_identical(geo_cell_solvers, dtype):
    """The bare step on the card == the eager cycles, bit for bit: the
    first step (it captures the graph) and three replays of the one graph,
    each handing back a copy that the next replay leaves alone."""
    solver = geo_cell_solvers[dtype]
    assert not solver.cfg.krylov and solver.cfg.n_multigrid == 2
    Ts = _geo_states(solver)
    got = []
    for T in Ts[:1] + Ts:
        got.append(solver._step_t(T))
        assert torch.equal(got[-1], _eager_step(solver, T))
    (graph,) = solver._graphs.values()
    assert graph.kind is semi.STEP_GRAPH
    assert list(solver._graphs)[0][0] == "step"
    assert len(graph.xs) == 2 and torch.equal(graph.xs[0], Ts[-1])
    assert torch.equal(graph.xs[1], solver._rhs_t(Ts[-1]))
    for g, T in zip(got[1:], Ts):
        assert g.data_ptr() != graph.y.data_ptr()
        assert torch.equal(g, _eager_step(solver, T))


def test_step_graph_counts_what_ran(geo_cell_solvers):
    """The capturing step counts one eager step's K1 launches, rounds and
    tiers and its 4 transfer launches, as each of N replayed steps does;
    the counters count one capture, N replays, and N times the replay's
    K1 launches (K1's alone), the least bytes of the cycles' K1 calls, as
    ``utils.profiling.least_bytes`` reckons an eager call's, and its
    transfer launches."""
    from p_a_multigrids_tpu_torch.utils import tracing

    def counts():
        return {"launches": K.KERNEL.launches, "rounds": K.KERNEL.rounds,
                "checked": K.CHECKED.launches,
                "transfer": transfer.KERNEL.launches,
                **{f"transfer_{e}": n
                   for e, n in transfer.KERNEL.by_entry.items()},
                **{f"tier_{t}": n for t, n in K.KERNEL.by_tier.items()}}

    def grown(a, b):
        return {k: b[k] - a[k] for k in a}

    solver = geo_cell_solvers[torch.float32]
    Ts = _geo_states(solver)
    n0 = counts()
    with K.watch() as calls:
        _eager_step(solver, Ts[0])
    eager = grown(n0, counts())
    assert eager["launches"] == len(calls) == 6
    assert eager["transfer"] == 2 * 2          # one level visit a cycle
    assert eager["transfer_restrict"] == eager["transfer_prolong_add"] == 2
    assert eager["checked"] == 0
    c0 = dict(tracing.snapshot()["counters"])
    n0 = counts()
    solver._step_t(Ts[0])
    torch.cuda.synchronize()
    assert grown(n0, counts()) == eager
    (graph,) = solver._graphs.values()
    assert graph.launches("k1") == eager["launches"]
    assert graph.least_bytes == sum(calls)
    for T in Ts:
        solver._step_t(T)
    torch.cuda.synchronize()
    assert grown(n0, counts()) == {k: (len(Ts) + 1) * v
                                   for k, v in eager.items()}
    c1 = tracing.snapshot()["counters"]

    def added(name):
        return c1.get(name, 0) - c0.get(name, 0)

    assert added("steps") == len(Ts) + 1
    assert added("step_graph_captures") == 1
    assert added("step_graph_replays") == len(Ts)
    assert added("step_graph_k1_launches") == len(Ts) * eager["launches"]
    assert added("step_graph_k1_least_bytes") == len(Ts) * sum(calls)
    assert (added("step_graph_transfer_launches")
            == len(Ts) * eager["transfer"])
    assert (tracing.snapshot()["kernels"]["transfer"]
            == transfer.KERNEL.launches)
    assert not [n for n in c1 if n.startswith("mg_graph_") and added(n)]


def test_step_graph_follows_the_sanitizer(geo_cell_solvers):
    """Sites given to the levels' operators after a capture (a solver made
    checked after it ran) make the next step capture the checked K1 build
    in the unchecked graph's place: its launches are all checked, its
    bits the unchecked graph's; with the sites taken off again the next
    step captures the unchecked build once more."""
    from p_a_multigrids_tpu_torch.utils import debugging
    solver = geo_cell_solvers[torch.float32]
    (T,) = _geo_states(solver, 1)
    want = solver._step_t(T)
    (unchecked,) = solver._graphs.values()
    san = debugging.Sanitizer(solver.device)
    for i, op in enumerate(solver.ops):
        op.sanitizer = san.site(f"level {i}", op.U)
    try:
        n0, c0 = K.KERNEL.launches, K.CHECKED.launches
        for _ in range(2):
            assert torch.equal(solver._step_t(T), want)
        torch.cuda.synchronize()
        assert K.KERNEL.launches == n0
        assert K.CHECKED.launches - c0 == 2 * unchecked.launches("k1")
        san.raise_on_fault()
        (checked,) = solver._graphs.values()
        assert (checked.launched["k1"][1]["launches"]
                == unchecked.launches("k1"))
    finally:
        for op in solver.ops:
            op.sanitizer = None
    assert torch.equal(solver._step_t(T), want)
    assert K.KERNEL.launches - n0 == unchecked.launches("k1")
    (graph,) = solver._graphs.values()
    assert all(site is None for site in graph.sites)


def test_step_graph_replays_are_traced(geo_cell_solvers):
    """One traced window of replayed steps, read as the benchmark reads
    it: the trace holds every replayed K1 launch the counter counted,
    each inside a ``pamg.step.graph`` range and outside every ``pamg.k1``
    range; ``k1_step_graph_hbm_roofline_share`` reads them at under 105%
    of the roofline and ``step_graph_replays_per_step`` one replay a
    step."""
    from p_a_multigrids_tpu_torch.utils import tracing
    from pamg_bench import spec, system, yardstick
    solver = geo_cell_solvers[torch.float32]
    Ts = _geo_states(solver)
    solver._step_t(Ts[0])
    torch.cuda.synchronize()
    (graph,) = solver._graphs.values()
    span = semi.STEP_GRAPH.span

    def window():
        for T in Ts:
            solver._step_t(T)

    for _ in range(5):
        tracing.reset()
        events, launched = yardstick.trace_window(window,
                                                  system.launch_counts)
        ks, _ = yardstick.read_window(events, ("pamg.k1", span))
        if yardstick.missing_launches(ks, launched) is None:
            break
    else:
        pytest.fail(yardstick.missing_launches(ks, launched))
    assert launched == {"k1_phase": graph.launches("k1") * len(Ts),
                        "k2_rowop": 0}
    k1 = [k for k in ks if k["cls"] == "k1_phase"]
    assert len(k1) == graph.launches("k1") * len(Ts)
    assert all(span in k["spans"] and "pamg.k1" not in k["spans"]
               for k in k1)
    share = spec.load_metric("k1_step_graph_hbm_roofline_share").read(
        {"kernels": ks})
    assert 0 < share <= 105
    replays = spec.load_metric("step_graph_replays_per_step").read({})
    assert replays == 1.0

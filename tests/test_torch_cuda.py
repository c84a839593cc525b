"""Kernels K1 and K2 on the GPU == their plain PyTorch versions
(phase_reference, rowop_reference).

This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)  Without a CUDA
device the kernel tests skip; the build test runs only where there is no
CUDA compiler.
"""

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
from p_a_multigrids_tpu_torch.ops import smoothers, spmv, stencil
from p_a_multigrids_tpu_torch.utils import cuda_build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernels K1 and K2 run only on "
                    "the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n_split", [0, 1, 2, 3, 4, 5])
def test_k1_matches_plain(cuda, n_split):
    """f32 sums of ~40 terms taken in another order, compounded over <= 7
    rounds with intermediate Chebyshev amplification: 1e-4 relative for
    multi-round phases, 1e-5 for the zero-round apply.  n_split 0 has 3
    cross slots per child, 1-5 the corner children's 2; n_split 4 and 5
    (C = 256 and 1024) are the TPU's PhaseOperatorResident regime, counted
    in launches_deep too."""
    cfg = SemiConfig(n_split=n_split, multi_levels=1, dt=0.05)
    L = semi.build_problem(structured.tri_mesh(6, 5, 0.2, 0.25),
                           cfg).levels[0]
    data = stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    op = stencil.StencilOperator(data, torch.float32, cuda)
    cheb = [1.0 / r for r in smoothers.chebyshev_roots(
        stencil.lam_max_estimate(data), 6, 0.1)]
    rng = np.random.default_rng(n_split)
    x, b = (torch.tensor(rng.normal(size=(3, op.C, op.U)),
                         dtype=torch.float32, device=cuda)
            for _ in range(2))
    for coefs, want_z, bp, rtol in (
            (cheb, True, op._bp(b, True), 1e-4),
            ([0.8] * 3, False, op._bp(b, False), 1e-4),
            ([], True, torch.zeros_like(x), 1e-5)):
        n0, d0 = K.KERNEL.launches, K.KERNEL.launches_deep
        xk, zk = K.phase(op, x, bp, coefs, want_z)
        torch.cuda.synchronize()
        assert K.KERNEL.launches - n0 == len(coefs) + int(want_z)
        assert K.KERNEL.launches_deep - d0 == (
            K.KERNEL.launches - n0 if op.C > K.DEEP_C else 0)
        xr, zr = K.phase_reference(op, x, bp, coefs, want_z)
        pairs = [(xk, xr), (zk, zr)] if want_z else [(xk, xr)]
        for got, ref in pairs:
            err = float((got - ref).abs().max())
            assert err <= rtol * float(ref.abs().max())


def test_k1_refuses_float64(cuda):
    cfg = SemiConfig(n_split=1, multi_levels=1, dt=0.05, dtype="float64")
    L = semi.build_problem(structured.tri_mesh(2, 2, 0.5, 0.5), cfg).levels[0]
    op = stencil.StencilOperator(
        stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta),
        torch.float64, cuda)
    x = torch.zeros((3, op.C, op.U), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K.phase(op, x, x, [0.5])


def _k2_matches_plain(op, x):
    """One K2 launch against rowop_reference: f32 sums of 3*D products
    (D <= 141) in another order, so 1e-5 of the largest |output|."""
    n0 = spmv.KERNEL.launches
    got = op(x)
    torch.cuda.synchronize()
    assert spmv.KERNEL.launches - n0 == 1
    want = spmv.rowop_reference(op.cols_t, op.vals_t, x)
    assert got.shape == want.shape == (3, op.n_out)
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape", [(1000, 1000, 13), (300, 1000, 25),
                                   (1000, 300, 3), (257, 40, 141)])
def test_k2_matches_plain(cuda, shape):
    """Square and rectangular random block rows, D up to the stand-in
    hierarchy's widest restriction."""
    n_out, n_src, D = shape
    rng = np.random.default_rng(D)
    op = spmv.RowOp(rng.integers(0, n_src, size=(n_out, D)),
                    rng.normal(size=(n_out, D, 3, 3)), n_src,
                    torch.float32, cuda)
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
    for op in h.rowops().values():
        x = torch.tensor(rng.normal(size=(3, op.n_src)),
                         dtype=torch.float32, device=cuda)
        _k2_matches_plain(op, x)


def test_k2_refuses_float64(cuda):
    op = spmv.RowOp(np.zeros((4, 2), np.int64), np.ones((4, 2, 3, 3)), 4,
                    torch.float64, cuda)
    n0 = spmv.KERNEL.launches
    with pytest.raises(TypeError, match="float32"):
        op(torch.zeros((3, 4), dtype=torch.float64, device=cuda))
    assert spmv.KERNEL.launches == n0


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    """No fallback: without nvcc the build raises instead of degrading."""
    if (os.path.isfile("/usr/local/cuda/bin/nvcc")
            or cuda_build.shutil.which("nvcc")):
        pytest.skip("a CUDA compiler is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    for name in ("phase", "spmv"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.load(name)

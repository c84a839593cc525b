"""Kernel K1 on the GPU == its plain PyTorch version (phase_reference).

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
from p_a_multigrids_tpu_torch.ops import phase as K
from p_a_multigrids_tpu_torch.ops import smoothers, stencil
from p_a_multigrids_tpu_torch.utils import cuda_build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("n_split", [0, 1, 2, 3])
def test_k1_matches_plain(cuda, n_split):
    """f32 sums of ~40 terms taken in another order, compounded over <= 7
    rounds with intermediate Chebyshev amplification: 1e-4 relative for
    multi-round phases, 1e-5 for the zero-round apply.  n_split 0 has 3
    cross slots per child, 1-3 the corner children's 2."""
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
        n0 = K.KERNEL.launches
        xk, zk = K.phase(op, x, bp, coefs, want_z)
        torch.cuda.synchronize()
        assert K.KERNEL.launches - n0 == len(coefs) + int(want_z)
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


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    """No fallback: without nvcc the build raises instead of degrading."""
    if (os.path.isfile("/usr/local/cuda/bin/nvcc")
            or cuda_build.shutil.which("nvcc")):
        pytest.skip("a CUDA compiler is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("phase")

"""Host-side pieces of the port's GPU profiler (no card needed)."""

import pytest
import torch

from p_a_multigrids_tpu_torch.config import SemiConfig
from p_a_multigrids_tpu_torch.mesh import structured
from p_a_multigrids_tpu_torch.models import semi
from p_a_multigrids_tpu_torch.utils import profiling


@pytest.mark.parametrize("n_split", [1, 2])
def test_least_bytes_counts_the_round_operands(n_split):
    cfg = SemiConfig(n_split=n_split, multi_levels=1, dt=0.05)
    op = semi.SemiSolver(semi.build_problem(
        structured.tri_mesh(4, 4, 0.25, 0.25), cfg), "cpu").ops[0]
    state = torch.empty((3, op.C, op.U))
    want = (op.Fp_t.numel() + op.Xp_t.numel() + 4 * state.numel()) * 4
    assert profiling.least_bytes(op, 4) == want


def test_kernel_class_and_busy_union():
    assert profiling.kernel_class("phase_round_kernel") == "k1_phase_round"
    assert profiling.kernel_class("sm90_xmma_gemm_f32f32") == "gemm"
    assert profiling.kernel_class("at::native::reduce_kernel<512>") == \
        "reduction"
    assert profiling.kernel_class("vectorized_elementwise_kernel") == \
        "elementwise_copy_fill"
    # overlapping [0, 5) and [3, 8), then [10, 12): 8 + 2 busy
    ks = [("a", 3.0, 5.0), ("b", 0.0, 5.0), ("c", 10.0, 2.0)]
    assert profiling._busy_us(ks) == 10.0


def test_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        profiling.main([])

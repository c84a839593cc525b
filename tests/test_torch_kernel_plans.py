"""The host plans of kernels K1 and K2 on an H100's numbers (no card
needed): which tier of K1 each main-path level gets, with its launch shape,
and which variant of K2 each SA operator shape gets, in float32 and in
float64."""

import torch_threads  # noqa: F401

import ctypes

import pytest
import torch

from p_a_multigrids_tpu_torch.ops import phase as K
from p_a_multigrids_tpu_torch.ops import spmv

# H100 SXM as k1_phase_limits reads it: 132 SMs, 227 KB of opt-in shared
# memory a block, one 1024-thread streaming block an SM (64 registers a
# thread)
H100 = dict(sm_count=132, smem_per_block=232448, stream_blocks_per_sm=1)


@pytest.mark.parametrize("C, U, tier", [
    (16, 8192, "resident"),     # bench-geometric / production amg level 0
    (4, 8192, "resident"),      # bench-geometric level 1
    (1024, 96, "resident"),     # level sweep level 0 (K3's regime)
    (256, 96, "resident"),      # level sweep level 1 (K3's regime)
    (64, 96, "resident"),       # level sweep levels 2-4
    (16, 96, "resident"),
    (4, 96, "small"),
    (1, 60, "small"),
    (64, 1152, "resident"),     # CLI main path (24 x 24, n_split 3)
    (4, 1152, "resident"),
    (1024, 1152, "stream"),     # n_split 5 on 24 x 24: C*U = 1,179,648
])
def test_phase_plan_tiers(C, U, tier):
    p = K.phase_plan(C, U, **H100)
    assert p.tier == tier
    # every pair has a block, every block has a pair, no block too large
    assert (p.grid - 1) * p.slice < C * U <= p.grid * p.slice
    assert p.threads <= K.MAX_THREADS and p.threads % 32 == 0
    if tier == "small":
        assert p.grid == 1 and p.slice == C * U
    elif tier == "resident":
        assert p.grid <= H100["sm_count"]
    else:
        assert p.grid <= H100["sm_count"] * H100["stream_blocks_per_sm"]
    assert p.smem == p.slice * {"small": K.small_bytes(4), "stream": 0,
                                "resident": K.resident_bytes(4)}[tier]
    assert p.smem <= H100["smem_per_block"]


def test_phase_plan_on_chip_sizes():
    """Fp, bp and index offsets on chip (160 B a pair): 159 KB a block at
    C = 16, U = 8192 and 119 KB at C = 1024, U = 96, one block per SM;
    189 MB at C*U = 1,179,648 do not fit 132 x 227 KB.  One block holds a
    whole level with its state (184 B a pair) up to 1,263 pairs."""
    assert K.phase_plan(16, 8192, **H100).smem == 993 * 160
    assert K.phase_plan(1024, 96, **H100).smem == 745 * 160
    assert K.phase_plan(1, 1263, **H100).tier == "small"
    assert K.phase_plan(1, 1264, **H100).tier == "resident"
    assert 1024 * 1152 * K.resident_bytes(4) > 132 * H100["smem_per_block"]


def test_phase_plan_forced_tiers():
    """Any level can stream; a level too large for a tier raises."""
    p = K.phase_plan(16, 8192, tier="stream", **H100)
    assert p.tier == "stream" and p.smem == 0 and p.grid == 132
    assert K.phase_plan(4, 96, tier="resident", **H100).tier == "resident"
    with pytest.raises(ValueError, match="small tier"):
        K.phase_plan(16, 96, tier="small", **H100)
    with pytest.raises(ValueError, match="resident tier"):
        K.phase_plan(1024, 1152, tier="resident", **H100)
    with pytest.raises(ValueError, match="unknown tier"):
        K.phase_plan(4, 96, tier="cluster", **H100)


@pytest.mark.parametrize("n_out, D, want", [
    (513, 141, ("lanes", 32, 144)),      # production l3_r
    (2047, 63, ("lanes", 16, 64)),       # production l2_r
    (2047, 33, ("lanes", 16, 36)),       # production l3_p
    (8223, 25, ("lanes", 8, 28)),
    (32768, 13, ("lanes", 4, 16)),       # production l0_op
    (32768, 8, ("lanes", 4, 8)),         # production l1_p
    (32768, 5, ("thread", 1, 5)),        # fine_tent_r
    (131072, 3, ("thread", 1, 3)),       # production l0_p
    (131072, 1, ("thread", 1, 1)),       # fine_tent_p
    (300, 1025, ("thread", 1, 1025)),    # sums beyond 48 KB a block
])
def test_rowop_plan(n_out, D, want):
    assert spmv.rowop_plan(n_out, D) == want


def test_rowop_plan_forced_variants():
    assert spmv.rowop_plan(513, 141, "thread") == ("thread", 1, 141)
    assert spmv.rowop_plan(32768, 13, "thread") == ("thread", 1, 13)
    assert spmv.rowop_plan(10, 1, "lanes") == ("lanes", 4, 4)
    with pytest.raises(ValueError, match="unknown variant"):
        spmv.rowop_plan(10, 10, "warp")


def test_phase_plan_bytes_a_pair():
    """30 values of the state's type and 10 int32 words a pair kept on
    chip, 6 values more in the small tier."""
    assert (K.resident_bytes(4), K.small_bytes(4)) == (160, 184)
    assert (K.resident_bytes(8), K.small_bytes(8)) == (280, 328)


@pytest.mark.parametrize("C, U, tier, smem", [
    (16, 8192, "stream", 0),             # bench-geometric fine level:
                                         # 993 x 280 B = 278 KB a block
    (1024, 96, "resident", 745 * 280),   # level sweep level 0: 209 KB
    (4, 96, "small", 384 * 328),         # level sweep's coarse C = 4
    (1, 708, "small", 708 * 328),        # the largest small level
    (1, 709, "resident", 6 * 280),
    (16, 1152, "resident", 140 * 280),   # CLI main path (24 x 24)
    (1, 131072, "stream", 0),            # mode 6 at 256 x 256: 993 pairs
])
def test_phase_plan_float64(C, U, tier, smem):
    """The float64 plans at the H100's figures: the small tier holds up to
    708 pairs (1,263 in float32), C = 16, U = 8192 no longer fits a block
    of 227 KB and streams, C = 1024, U = 96 stays resident."""
    p = K.phase_plan(C, U, itemsize=8, **H100)
    assert (p.tier, p.smem) == (tier, smem)
    assert (p.grid - 1) * p.slice < C * U <= p.grid * p.slice
    assert p.smem <= H100["smem_per_block"]


def test_phase_plan_float32_unchanged_by_itemsize_argument():
    for C, U in ((16, 8192), (1024, 96), (4, 96), (1, 1263), (1, 131072),
                 (1024, 1152)):
        assert K.phase_plan(C, U, **H100) == K.phase_plan(C, U, itemsize=4,
                                                          **H100)
    assert K.phase_plan(16, 8192, **H100).tier == "resident"


@pytest.mark.parametrize("dtype, scalar", [(torch.float32, ctypes.c_float),
                                           (torch.float64, ctypes.c_double)])
def test_launch_rounds_in_the_state_dtype(dtype, scalar):
    """The ctypes step sizes of a launch are _round_coefs in the state's
    dtype, bit for bit, cut into launches of at most MAX_ROUNDS rounds."""
    coefs = tuple(1.0 / (0.1 + 0.37 * k) for k in range(K.MAX_ROUNDS + 9))
    chunks = K._launch_rounds(coefs, True, dtype)
    assert [len(c) for c in chunks] == [K.MAX_ROUNDS, 10]
    assert all(c._type_ is scalar for c in chunks)
    want = K._round_coefs(coefs, True, dtype)
    got = [v for c in chunks for v in c]
    assert torch.equal(torch.tensor(got, dtype=torch.float64),
                       torch.tensor(want, dtype=torch.float64))
    if dtype == torch.float64:
        assert got == list(coefs) + [0.0]
        assert got != K._round_coefs(coefs, True, torch.float32)


def test_rowop_plan_float64():
    """In float64 the lanes variant takes rows of up to 512 slots (48 KB
    of slot sums a block of 4 rows), wider rows one thread a row; below
    that the variant, lanes and padding are float32's."""
    assert spmv.lanes_max_d(4) == 1024 and spmv.lanes_max_d(8) == 512
    assert spmv.rowop_plan(300, 512, itemsize=8) == ("lanes", 32, 512)
    assert spmv.rowop_plan(300, 513, itemsize=8) == ("thread", 1, 513)
    assert spmv.rowop_plan(300, 513) == ("lanes", 32, 516)
    for n_out, D in ((513, 141), (2047, 63), (32768, 13), (32768, 5),
                     (131072, 3)):
        assert (spmv.rowop_plan(n_out, D, itemsize=8)
                == spmv.rowop_plan(n_out, D))

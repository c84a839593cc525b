"""The host plans of kernels K1 and K2 on an H100's numbers (no card
needed): which tier of K1 each main-path level gets, with its launch shape,
and which variant of K2 each SA operator shape gets."""

import pytest

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
    assert p.smem == p.slice * {"small": K.SMALL_BYTES, "stream": 0,
                                "resident": K.RESIDENT_BYTES}[tier]
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
    assert 1024 * 1152 * K.RESIDENT_BYTES > 132 * H100["smem_per_block"]


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

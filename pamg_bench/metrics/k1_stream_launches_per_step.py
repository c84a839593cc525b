"""Kernel K1's launches in its streaming tier a time step: the program's
``k1_by_tier["stream"]`` (each eager launch, and those a CUDA graph's
replay credits) over its ``steps`` counter, both over the whole process
(warm-up and traced windows).  0 where no level streams (a level that
falls back to a path without K1); nothing from a program without K1's
counts by tier in its snapshot (``utils.tracing``)."""

LAYER = "relaxation phase K1"
SOURCE = "program_counter"
MOVES = "step_ms"
TIER = "stream"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    steps = snap["counters"].get("steps")
    by_tier = snap["kernels"].get("k1_by_tier")
    if not steps or by_tier is None:
        return None
    return by_tier.get(TIER, 0) / steps

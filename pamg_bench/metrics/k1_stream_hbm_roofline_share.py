"""Kernel K1's share of its memory roofline in its streaming tier, in %:
the K1 kernels of the traced windows that ran the streaming tier
(``phase_kernel<float, 2>`` or ``<double, 2>``, eager and replayed alike),
each taken at the least bytes of a streaming launch on average (the
program's ``k1_least_bytes_by_tier`` over its ``k1_by_tier``, both
"stream", over the whole process; each launch reckoned as
``yardstick.least_bytes`` reckons a call), over the H100's 3.35 TB/s,
divided by those kernels' device time.  The streaming tier runs the
levels whose working set the card's shared memory cannot hold, so it
reads from L2 or device memory every round.  Returns nothing from a
program without K1's bytes by tier (``utils.tracing``) or where no
streaming launch was traced."""

import re

from pamg_bench.yardstick import HBM_BYTES_PER_S

LAYER = "relaxation phase K1"
SOURCE = "device_trace"
MOVES = "step_ms"
TIER = "stream"
# the kernel's tier is its second template argument (csrc/phase.cu kStream)
NAME = re.compile(r"phase_kernel<\s*(float|double)\s*,\s*2\s*>")


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    kernels = tracing.snapshot()["kernels"]
    launches = kernels.get("k1_by_tier", {}).get(TIER)
    nbytes = kernels.get("k1_least_bytes_by_tier", {}).get(TIER)
    streamed = [k["dur"] for k in record.get("kernels", ())
                if NAME.search(k["name"])]
    if not launches or not nbytes or not streamed or not sum(streamed):
        return None
    traced = len(streamed) * nbytes / launches
    return 100.0 * (traced / HBM_BYTES_PER_S) / (sum(streamed) * 1e-6)

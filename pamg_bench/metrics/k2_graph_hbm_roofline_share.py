"""Kernel K2's share of its memory roofline in the SA cycle's CUDA graph,
in %: the K2 kernels of the traced windows launched outside every ``k2``
span (every K2 call made one by one is spanned, so these are the graph's
replayed launches), each taken at the least bytes of a replayed K2 launch
on average (the program's ``sa_graph_k2_least_bytes`` counter over its
``sa_graph_k2_launches``), over the H100's 3.35 TB/s, divided by those
kernels' device time.  A window holds whole replays of the one graph a
cell captures, so the average gives their bytes exactly.  Returns nothing
from a program without the counters (``utils.tracing``)."""

from pamg_bench.yardstick import HBM_BYTES_PER_S

LAYER = "SA correction K2"
SOURCE = "device_trace"
MOVES = "step_ms"
SPAN = "k2"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    counters = tracing.snapshot()["counters"]
    launches = counters.get("sa_graph_k2_launches")
    nbytes = counters.get("sa_graph_k2_least_bytes")
    replayed = [k["dur"] for k in record.get("kernels", ())
                if k["cls"] == "k2_rowop" and SPAN not in k["spans"]]
    if not launches or not nbytes or not replayed or not sum(replayed):
        return None
    traced = len(replayed) * nbytes / launches
    return 100.0 * (traced / HBM_BYTES_PER_S) / (sum(replayed) * 1e-6)

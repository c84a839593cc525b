"""Kernel K1's share of its memory roofline in the bare time step's CUDA
graph, in %: the K1 kernels of the traced windows launched outside every
``k1`` span (every K1 call made one by one is spanned, so these are the
graph's replayed launches), each taken at the least bytes of a replayed
K1 launch on average (the program's ``step_graph_k1_least_bytes`` counter
over its ``step_graph_k1_launches``; each call's bytes reckoned as
``yardstick.least_bytes`` reckons an eager one's), over the H100's 3.35
TB/s, divided by those kernels' device time.  A window holds whole
replays of the one graph a cell captures, so the average gives their
bytes exactly.  Returns nothing from a program without the counters
(``utils.tracing``)."""

from pamg_bench.yardstick import HBM_BYTES_PER_S

LAYER = "relaxation phase K1"
SOURCE = "device_trace"
MOVES = "step_ms"
SPAN = "k1"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    counters = tracing.snapshot()["counters"]
    launches = counters.get("step_graph_k1_launches")
    nbytes = counters.get("step_graph_k1_least_bytes")
    replayed = [k["dur"] for k in record.get("kernels", ())
                if k["cls"] == "k1_phase" and SPAN not in k["spans"]]
    if not launches or not nbytes or not replayed or not sum(replayed):
        return None
    traced = len(replayed) * nbytes / launches
    return 100.0 * (traced / HBM_BYTES_PER_S) / (sum(replayed) * 1e-6)

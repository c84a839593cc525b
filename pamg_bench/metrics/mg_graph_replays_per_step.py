"""Replays of the geometric Krylov preconditioner's CUDA graph a time
step: the program's ``mg_graph_replays`` counter over its ``steps``
counter, both over the whole process (warm-up and traced windows).
Returns nothing from a program without the counter (``utils.tracing``)."""

LAYER = "geometric preconditioner"
SOURCE = "program_counter"
MOVES = "step_ms"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    counters = tracing.snapshot()["counters"]
    if not counters.get("steps") or "mg_graph_replays" not in counters:
        return None
    return counters["mg_graph_replays"] / counters["steps"]

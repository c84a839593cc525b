"""Replays of the bare time step's CUDA graph (the step's cycles) a time
step: the program's ``step_graph_replays`` counter over its ``steps``
counter, both over the whole process (warm-up and traced windows).
Returns nothing from a program without the counter (``utils.tracing``)."""

LAYER = "time step"
SOURCE = "program_counter"
MOVES = "step_ms"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    counters = tracing.snapshot()["counters"]
    if not counters.get("steps") or "step_graph_replays" not in counters:
        return None
    return counters["step_graph_replays"] / counters["steps"]

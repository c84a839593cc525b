"""Device-to-host reads a time step makes in the Krylov loops: the
program's ``host_syncs`` counter over its ``steps`` counter, both over
the whole process (warm-up and traced windows).  Returns nothing from a
program without its own counters (``utils.tracing``)."""

LAYER = "Krylov"
SOURCE = "program_counter"
MOVES = "step_ms"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    counters = tracing.snapshot()["counters"]
    if not counters.get("steps"):
        return None
    return counters.get("host_syncs", 0) / counters["steps"]

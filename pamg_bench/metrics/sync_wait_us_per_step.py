"""Host microseconds a time step spends in the Krylov loops' device reads:
the host time inside the program's ``pamg.sync`` spans over its
``pamg.step`` spans, both recorded only while the profiler records (the
traced windows).  Returns nothing from a program without its own spans
(``utils.tracing``)."""

LAYER = "Krylov"
SOURCE = "program_counter"
MOVES = "step_ms"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    steps = spans.get("pamg.step", {}).get("calls", 0)
    if not steps:
        return None
    return spans.get("pamg.sync", {}).get("host_us", 0.0) / steps

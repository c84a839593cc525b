"""The 95th percentile of the host-clock times of all steps of the
window, each from its start to its residual on the host (Python's
``statistics.quantiles`` with n = 20, the exclusive method)."""

import statistics

LAYER = "time step"
SOURCE = "host_clock"
MOVES = "step_ms_p95"


def read(record):
    steps = record["step_s"]
    if len(steps) < 20:
        return None
    return 1e3 * statistics.quantiles(steps, n=20)[-1]

"""Time of the whole window over the steps it completed: each step is
``st.step`` and the residual read on the host (host clock)."""

LAYER = "time step"
SOURCE = "host_clock"
MOVES = "step_ms"


def read(record):
    return 1e3 * record["window_s"] / record["steps"]

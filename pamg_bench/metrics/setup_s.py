"""Seconds from the process start (the first line of ``run.py``) to the
first timed step: imports, CUDA, kernel load (and build, in a fresh
checkout), the solver's build, the initial states and the warm-up on the
cell's own shapes."""

LAYER = "set-up"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(record):
    return record["setup_s"]

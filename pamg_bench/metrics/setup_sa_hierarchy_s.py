"""Seconds of the set-up stage ``pamg.setup.sa_hierarchy``: the host build
of the SA hierarchy (``agg.build_hierarchy``), on the program's host
clock (``utils.tracing``).  Returns nothing from a program without its
own stages, or where the stage did not run."""

LAYER = "set-up"
SOURCE = "program_counter"
MOVES = "setup_s"
STAGE = "pamg.setup.sa_hierarchy"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    stage = tracing.snapshot()["stages"].get(STAGE)
    return None if stage is None else stage["s"]

"""Seconds of the set-up stage ``pamg.setup.problem``: the host tables of
every level (``semi.build_problem``, NumPy), on the program's host clock
(``utils.tracing``).  Returns nothing from a program without its own
stages, or where the stage did not run."""

LAYER = "set-up"
SOURCE = "program_counter"
MOVES = "setup_s"
STAGE = "pamg.setup.problem"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    stage = tracing.snapshot()["stages"].get(STAGE)
    return None if stage is None else stage["s"]

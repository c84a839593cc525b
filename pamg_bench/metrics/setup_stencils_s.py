"""Seconds of the set-up stage ``pamg.setup.stencils``: the closed-form
block stencils of every level, built on the host (``SemiSolver.__init__``
on the stencil path), on the program's host clock (``utils.tracing``).
Returns nothing from a program without its own stages, or where the stage
did not run (a solver on the non-stencil path)."""

LAYER = "set-up"
SOURCE = "program_counter"
MOVES = "setup_s"
STAGE = "pamg.setup.stencils"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    stage = tracing.snapshot()["stages"].get(STAGE)
    return None if stage is None else stage["s"]

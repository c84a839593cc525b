"""Seconds of the set-up stage ``pamg.setup.solver``: the solver's build
(``SemiSolver.__init__``: the stencils, the lam_max estimates, the coarse
inverse, the SA hierarchy, the device uploads), on the program's host
clock (``utils.tracing``).  Returns nothing from a program without its
own stages, or where the stage did not run."""

LAYER = "set-up"
SOURCE = "program_counter"
MOVES = "setup_s"
STAGE = "pamg.setup.solver"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    stage = tracing.snapshot()["stages"].get(STAGE)
    return None if stage is None else stage["s"]

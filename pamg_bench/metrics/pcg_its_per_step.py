"""PCG iterations a time step: the growth of the solver's
``krylov_iters`` over the steps traced."""

LAYER = "Krylov"
SOURCE = "program_counter"
MOVES = "step_ms"


def read(record):
    if not record.get("krylov"):
        return None
    return record["krylov_its"] / record["steps"]

"""Device microseconds a time step spends in the theta right-hand side:
the kernels launched inside ``SemiSolver._rhs_t`` calls (the step's and
the residual read's), over the steps traced."""

LAYER = "theta right-hand side"
SOURCE = "device_trace"
MOVES = "step_ms"
SPAN = "rhs"


def read(record):
    if not record.get("kernels") or not record["calls"].get(SPAN):
        return None
    return sum(k["dur"] for k in record["kernels"]
               if SPAN in k["spans"]) / record["steps"]

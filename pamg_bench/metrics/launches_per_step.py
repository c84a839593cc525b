"""Device kernels a time step launches: the kernels of the traced windows
(the priming fills left out) over the steps traced."""

LAYER = "time step"
SOURCE = "device_trace"
MOVES = "step_ms"


def read(record):
    if not record.get("kernels"):
        return None
    return len(record["kernels"]) / record["steps"]

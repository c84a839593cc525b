"""Level-transfer kernel launches a time step: the launch count of the
hand-written restriction and prolongation of the geometric cycle (the
kernel ``transfer`` of the program's snapshot: each eager launch, and
those a CUDA graph's replay credits) over the program's ``steps``
counter, both over the whole process (warm-up and traced windows).
Returns nothing from a program without that kernel (``utils.tracing``)."""

LAYER = "geometric preconditioner"
SOURCE = "program_counter"
MOVES = "step_ms"


def read(record):
    try:
        from p_a_multigrids_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    steps = snap["counters"].get("steps")
    if not steps or "transfer" not in snap["kernels"]:
        return None
    return snap["kernels"]["transfer"] / steps

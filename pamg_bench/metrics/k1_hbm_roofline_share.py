"""Kernel K1's share of its memory roofline, in %: the least bytes of
every relaxation-phase call the solver made in the traced windows
(``yardstick.least_bytes``: 27 coupling values and 2-4 state planes a
child) over the H100's 3.35 TB/s, divided by the device time of the
kernels launched inside those calls."""

from pamg_bench.yardstick import HBM_BYTES_PER_S

LAYER = "relaxation phase K1"
SOURCE = "device_trace"
MOVES = "step_ms"
SPAN = "k1"


def read(record):
    us = sum(k["dur"] for k in record.get("kernels", ())
             if SPAN in k["spans"])
    nbytes = record.get("least_bytes", {}).get(SPAN, 0)
    if not us or not nbytes:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (us * 1e-6)

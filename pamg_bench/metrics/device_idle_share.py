"""The device's idle share of the traced windows, in %: 100 (1 - the
union of the kernel intervals / the span from the first kernel's start to
the last one's end), summed over the windows (the gaps between windows
left out)."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "step_ms"


def read(record):
    if not record.get("span_us"):
        return None
    return 100.0 * (1.0 - record["busy_us"] / record["span_us"])

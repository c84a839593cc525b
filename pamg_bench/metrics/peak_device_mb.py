"""``torch.cuda.max_memory_allocated()`` over set-up and window, after
``reset_peak_memory_stats()`` at the start, in MiB."""

LAYER = "device"
SOURCE = "host_clock"
MOVES = "peak_device_mb"


def read(record):
    peak = record["memory_peak_bytes"]
    return peak / 2 ** 20 if peak else None

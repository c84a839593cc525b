"""The port's own spans, set-up stages and counters.

- ``span(name)``: while a torch profiler records, a ``record_function``
  range: it lands in the profiler's Chrome trace beside the kernels, so
  every kernel launched inside it can be given to it by correlation id.
  Its host time, and its self time (less the spans opened inside it), add
  to ``snapshot()["spans"][name]``.  Otherwise one flag check and a shared
  no-op context: no clock read, no allocation.
- ``stage(name)``: a set-up stage, always timed on the host clock into
  ``snapshot()["stages"][name]``; a span as well while recording.
- ``count(name, n)``: an always-on integer counter.
- ``sync(flag)``: ``bool(flag)``, one device-to-host read of a condition
  the caller computed beforehand, counted in ``host_syncs``; while
  recording it is the span ``pamg.sync``, so its host time is the time the
  host waited for the device.

"Recording" is the profiler's own flag (``torch._C._autograd.
_profiler_enabled``), true exactly while ``torch.profiler.profile``
records.  The state is plain Python numbers, never a tensor.  This module
imports only torch and the standard library, since ``ops`` and ``models``
import it; ``snapshot()`` reads the kernels' launch counters
(``ops.phase.KERNEL``, with its launches and least bytes by tier,
``ops.spmv.KERNEL``, ``ops.transfer.KERNEL``) where those modules are
loaded.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

SYNC = "pamg.sync"

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_PKG = __name__.rsplit(".", 2)[0]

_counters: dict[str, int] = {}
_stages: dict[str, list] = {}        # name -> [calls, seconds]
_spans: dict[str, list] = {}         # name -> [calls, host ns, self ns]
# the host ns covered by child spans, one entry for each open span
_open: list[int] = []


class _Span:
    """A recording span: a ``record_function`` range, timed on the host."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        _open.append(0)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        child = _open.pop()
        if _open:
            _open[-1] += dt
        agg = _spans.get(self.name)
        if agg is None:
            agg = _spans[self.name] = [0, 0, 0]
        agg[0] += 1
        agg[1] += dt
        agg[2] += dt - child
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A span named ``name`` around a block (see the module's doc)."""
    if not _recording():
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def stage(name: str):
    """A set-up stage: its host seconds add to ``stages[name]``."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        agg = _stages.get(name)
        if agg is None:
            agg = _stages[name] = [0, 0.0]
        agg[0] += 1
        agg[1] += time.perf_counter() - t0


def count(name: str, n: int = 1):
    """Add n to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def sync(flag) -> bool:
    """``bool(flag)`` of a device condition: one host sync, counted in
    ``host_syncs``, and the span ``pamg.sync`` while recording."""
    _counters["host_syncs"] = _counters.get("host_syncs", 0) + 1
    if not _recording():
        return bool(flag)
    with _Span(SYNC):
        return bool(flag)


def _kernel_counts() -> dict:
    """The launch counters of kernels K1 and K2 (and of their checked
    builds) and of the level-transfer kernels, read from their modules
    where those are loaded; K1's also by tier, with the least bytes of
    those launches (``k1_by_tier``, ``k1_least_bytes_by_tier``: dicts
    tier -> count)."""
    out = {}
    k1 = sys.modules.get(f"{_PKG}.ops.phase")
    if k1 is not None:
        out.update(k1_phase=k1.KERNEL.launches, k1_rounds=k1.KERNEL.rounds,
                   k1_phase_checked=k1.CHECKED.launches,
                   k1_by_tier=dict(k1.KERNEL.by_tier),
                   k1_least_bytes_by_tier=dict(
                       k1.KERNEL.least_bytes_by_tier))
    k2 = sys.modules.get(f"{_PKG}.ops.spmv")
    if k2 is not None:
        out.update(k2_rowop=k2.KERNEL.launches,
                   k2_rowop_checked=k2.CHECKED.launches)
    tr = sys.modules.get(f"{_PKG}.ops.transfer")
    if tr is not None:
        out.update(transfer=tr.KERNEL.launches)
    return out


def snapshot() -> dict:
    """The counters, the stages ({"calls", "s"}), the recorded spans
    ({"calls", "host_us", "self_us"}) and the kernels' launch counts (and
    K1's by tier, ``_kernel_counts``), as plain Python data."""
    return {
        "counters": dict(_counters),
        "stages": {n: {"calls": c, "s": s} for n, (c, s) in _stages.items()},
        "spans": {n: {"calls": c, "host_us": h * 1e-3, "self_us": s * 1e-3}
                  for n, (c, h, s) in _spans.items()},
        "kernels": _kernel_counts(),
    }


def reset():
    """Clear the counters, the stages and the span aggregates (not the
    kernels' own counters)."""
    _counters.clear()
    _stages.clear()
    _spans.clear()

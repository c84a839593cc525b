"""A device function replayed as one CUDA graph: the capture and replay
that the SA cycle (``ops/agg.vcycle_iter``), the geometric Krylov
preconditioner and the bare time step's cycles (``models/semi``) share.

``cached(cache, key, sites, make, rs)`` returns fn(*rs) on a tuple rs of
CUDA tensors through the graph that ``cache`` keeps under ``key``.  The
first call for a key, and the first after the sanitizer sites ``sites`` of
the operators fn applies have changed (a solver made checked after it
ran), captures the graph in the old one's place (``make``, which calls
``capture``): fn runs eagerly on a side stream, which gives the call's
result and sets the kernels' libraries and cuBLAS up there, and is then
captured on that stream, reading the static inputs ``xs`` (a copy of each
of rs) and writing the static output ``y`` in the graph's private memory
pool.  A graph launches the kernel builds, checked or not, that its
capture saw.  Nothing runs while fn is captured, so the launch counters of
the kind's kernels are set back after it: the call counts one eager
run's launches, as a replay does.  Later calls replay
(``Graph.__call__``).

Each kind of graph (``Kind``) has its span and counters in
``utils.tracing``: ``<prefix>_captures``, ``<prefix>_replays``, and, added
on each replay, ``<prefix>_<kernel>_launches`` for each of its kernels (the
launches the capture recorded) and ``<prefix>_<kernel>_least_bytes`` for
its first kernel (the least bytes of those calls, ``watch``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import torch

from ..utils import tracing


@dataclasses.dataclass(frozen=True)
class Kind:
    """One kind of graph: ``span`` is the span of a replay; ``prefix``
    names its counters; ``kernels`` pairs the name of each kernel in its
    counters with the kernel objects (its builds) whose launch counters
    (their attributes named in ``COUNTERS``) a replay adds to, the first
    kernel the one whose calls ``watch`` records; with ``copy_out`` a
    replay returns a copy of the static output, else the output itself,
    which the next replay overwrites."""
    span: str
    prefix: str
    kernels: tuple          # ((name, (kernel object, ...)), ...)
    copy_out: bool


def _counts(kernel) -> dict:
    return {n: copy.copy(getattr(kernel, n)) for n in kernel.COUNTERS}


def _delta(after: dict, before: dict) -> dict:
    return {n: ({k: v - before[n][k] for k, v in a.items()}
                if isinstance(a, dict) else a - before[n])
            for n, a in after.items()}


def _credit(kernel, delta: dict):
    for n, d in delta.items():
        if isinstance(d, dict):
            tally = getattr(kernel, n)
            for k, v in d.items():
                tally[k] += v
        else:
            setattr(kernel, n, getattr(kernel, n) + d)


@dataclasses.dataclass
class Graph:
    """A captured graph (``capture``): it reads the static inputs ``xs``
    and writes the static output ``y``; ``sites`` are the sanitizer sites
    its capture saw; ``launched`` holds, by the name of each of the kind's
    kernels, what one run adds to the counters of each of its objects;
    and ``least_bytes`` the least bytes of the first kernel's calls of
    one run."""
    kind: Kind
    graph: torch.cuda.CUDAGraph
    xs: tuple
    y: torch.Tensor
    sites: tuple
    launched: dict
    least_bytes: int

    def launches(self, kernel: str) -> int:
        """Launches of the kernel named ``kernel`` in one replay."""
        return sum(d["launches"] for d in self.launched[kernel])

    def __call__(self, *rs):
        """fn on rs: copy each into its ``xs``, replay on the current
        stream and take ``y`` or its copy, in the kind's span; then
        count."""
        kind = self.kind
        with tracing.span(kind.span):
            for x, r in zip(self.xs, rs):
                x.copy_(r)
            self.graph.replay()
            out = self.y.clone() if kind.copy_out else self.y
        for name, objs in kind.kernels:
            for kernel, delta in zip(objs, self.launched[name]):
                _credit(kernel, delta)
            tracing.count(f"{kind.prefix}_{name}_launches",
                          self.launches(name))
        tracing.count(f"{kind.prefix}_replays")
        tracing.count(f"{kind.prefix}_{kind.kernels[0][0]}_least_bytes",
                      self.least_bytes)
        return out


def capture(kind: Kind, fn: Callable, rs: tuple, sites: tuple, watch):
    """The graph of fn on the dtypes, device and shapes of the tuple rs,
    and fn(*rs) (see the module's doc).  ``watch`` is a context manager
    around the capture that yields a list, which holds the least bytes of
    each call of the kind's first kernel made inside it once it has
    exited."""
    dev = rs[0].device
    xs = tuple(r.clone() for r in rs)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        e = fn(*xs)
    before = [(k, _counts(k)) for _, group in kind.kernels for k in group]
    graph = torch.cuda.CUDAGraph()
    try:
        with watch as calls, torch.cuda.graph(graph, stream=side):
            y = fn(*xs)
        deltas = {id(k): _delta(_counts(k), b) for k, b in before}
        launched = {name: tuple(deltas[id(k)] for k in group)
                    for name, group in kind.kernels}
    finally:
        for k, b in before:
            for n, v in b.items():
                setattr(k, n, v)
    # the caller reads e on its own stream
    torch.cuda.current_stream(dev).wait_stream(side)
    e.record_stream(torch.cuda.current_stream(dev))
    tracing.count(f"{kind.prefix}_captures")
    return Graph(kind, graph, xs, y, sites, launched, sum(calls)), e


def cached(cache: dict, key, sites: tuple, make: Callable, rs: tuple):
    """The call on the tuple rs through the graph ``cache[key]``:
    ``make()``, which captures it (``capture``) and returns (the graph,
    the call's result), at the first call for ``key`` and again, in its
    place, when ``sites`` differ from its capture's; else a replay."""
    graph = cache.get(key)
    if graph is None or graph.sites != sites:
        cache.pop(key, None)
        cache[key], e = make()
        return e
    return graph(*rs)

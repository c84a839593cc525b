"""Collectives of the distributed solvers over ``torch.distributed``, and
the launcher of their rank processes.

``RingComm`` is the port's counterpart of what ``shard_map`` gave the JAX
package's distributed solvers, over one process group with one process per
rank:

- ``rank`` / ``world``: ``axis_index`` and the axis size;
- ``ring_halo``: the k-hop ring exchange of the JAX package's
  ``parallel/stencil_solver._ring_halo`` (``ceil(H / U_loc)`` neighbour
  hops a side, each hop one send and one receive per direction, posted
  together in one ``batch_isend_irecv``; blocks that wrap around the ring
  land only on clamped rows of the extended domain, which nothing reads);
- ``all_reduce_sum``: ``psum``, as an ``all_gather`` of the partial values
  summed in rank order, so that every rank holds the same bits and control
  flow that reads a reduced value (a Krylov stopping test) agrees on every
  rank, whatever the backend's reduction order;
- ``all_gather``: ``all_gather(..., tiled=True)`` along any dimension.

The backend follows one rule (``backend_for``): ``nccl`` when the ranks run
on CUDA and each has a card of its own (rank r on ``cuda:r``), otherwise
``gloo``: CPU ranks, or CUDA ranks sharing cards, whose kernels still run
on the card while every message goes through pinned host buffers (the
staging copies are timed in ``RingComm.stats``).  Nothing falls back from
one backend to the other.

``launch(fn, world, device, args)`` spawns the ranks, each of which calls
``fn(comm, *args)`` (``fn`` a module-level function, so that a spawned
process imports it by name); it joins them with a deadline, and when a rank
fails it stops the others and raises the error of the rank that failed
first (RuntimeError, with that rank's traceback).
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# BLAS and OpenMP pool sizes a spawned rank reads at start-up
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def backend_for(device, world: int) -> str:
    """``nccl`` when ``device`` is CUDA and every one of ``world`` ranks
    has a card of its own, else ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device of rank ``rank``: ``cuda:(rank mod cards)`` for CUDA
    ranks (``cuda:rank`` under nccl), the CPU for CPU ranks."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


class RingComm:
    """The collectives of one rank over the default process group, for
    tensors on ``device``.

    ``stats`` counts the messages and bytes this rank sent, the host
    seconds spent copying CUDA tensors to and from pinned host buffers
    (``staging_s``, gloo on CUDA only) and the host seconds spent waiting
    for messages (``wait_s``); ``reset_stats`` zeroes them.
    """

    def __init__(self, device):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.device = torch.device(device)
        self.backend = str(dist.get_backend())
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.reset_stats()

    def reset_stats(self):
        self.stats = dict(messages=0, bytes=0, staging_s=0.0, wait_s=0.0)

    # -- host staging (gloo with CUDA tensors) --------------------------------
    def _out(self, tensors):
        """Contiguous copies to send: pinned host copies when staged."""
        if not self.staged:
            return [t.contiguous() for t in tensors]
        # the copies wait for the kernels that produce the tensors: finish
        # those first, so that staging_s holds the copies alone
        torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            host.append(h)
        self.stats["staging_s"] += time.perf_counter() - t0
        return host

    def _in(self, tensors):
        """Received tensors on this rank's device."""
        if not self.staged:
            return tensors
        t0 = time.perf_counter()
        out = [t.to(self.device) for t in tensors]
        self.stats["staging_s"] += time.perf_counter() - t0
        return out

    def _buffers(self, like):
        return [torch.empty(t.shape, dtype=t.dtype, device=t.device,
                            pin_memory=self.staged) for t in like]

    def _count(self, tensors):
        self.stats["messages"] += len(tensors)
        self.stats["bytes"] += sum(t.numel() * t.element_size()
                                   for t in tensors)

    # -- point to point -------------------------------------------------------
    def _exchange(self, to_next, to_prev):
        """Send ``to_next`` to rank + 1 and ``to_prev`` to rank - 1 (on the
        ring); returns (what rank - 1 sent forward, what rank + 1 sent
        back).  The four operations are posted together, in the same order
        on every rank."""
        if self.world == 1:
            return to_next, to_prev
        nxt = (self.rank + 1) % self.world
        prv = (self.rank - 1) % self.world
        a, b = self._out([to_next, to_prev])
        ra, rb = self._buffers([a, b])
        ops = [dist.P2POp(dist.isend, a, nxt, tag=0),
               dist.P2POp(dist.irecv, ra, prv, tag=0),
               dist.P2POp(dist.isend, b, prv, tag=1),
               dist.P2POp(dist.irecv, rb, nxt, tag=1)]
        t0 = time.perf_counter()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.stats["wait_s"] += time.perf_counter() - t0
        self._count([a, b])
        return tuple(self._in([ra, rb]))

    def ring_halo(self, x, H: int):
        """(left, right) halos of width ``H`` along the last axis: the H
        entries of the global array just before and just after this rank's
        block, taken from the ranks before and after it on the ring
        (``ceil(H / U_loc)`` hops a side; on the first and last ranks the
        blocks that wrap around the ring stand where the global array
        ends)."""
        U_loc = x.shape[-1]
        hops = -(-H // U_loc)
        left, right = [], []
        cl = cr = x
        for hop in range(hops):
            # every hop but the last forwards whole blocks; the last sends
            # only the part of a block that lies within H
            w = H - (hops - 1) * U_loc if hop == hops - 1 else U_loc
            cl, cr = self._exchange(cl[..., U_loc - w:], cr[..., :w])
            left.append(cl)
            right.append(cr)
        return torch.cat(left[::-1], dim=-1), torch.cat(right, dim=-1)

    # -- collectives ----------------------------------------------------------
    def all_gather(self, x, dim: int = 0):
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        if self.world == 1:
            return x
        (t,) = self._out([x])
        parts = self._buffers([t] * self.world)
        t0 = time.perf_counter()
        dist.all_gather(parts, t)
        self.stats["wait_s"] += time.perf_counter() - t0
        self._count([t])
        return self._in([torch.cat(parts, dim=dim)])[0]

    def all_reduce_sum(self, x):
        """The sum of every rank's ``x``, taken in rank order on each rank
        (the same bits everywhere)."""
        if self.world == 1:
            return x
        parts = self.all_gather(x[None], 0)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def barrier(self):
        dist.barrier()


def _rank_main(rank, fn, world, device, backend, tmp, args, pg_timeout,
               threads):
    """One spawned rank: join the process group, run ``fn(comm, *args)``
    and leave its result in ``tmp`` for ``launch``."""
    torch.set_num_threads(threads)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=pg_timeout))
    try:
        out = fn(RingComm(dev), *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".part", path)
    except BaseException:
        # when a rank fails, its peers fail too (a closed connection): the
        # time stamp tells ``launch`` which failed first
        with open(os.path.join(tmp, f"error{rank}"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, device="cuda", args: tuple = (),
           timeout: float = 600.0, pg_timeout: float = 60.0,
           threads: int = 1) -> list:
    """Run ``fn(comm, *args)`` on ``world`` spawned ranks on ``device``
    (each rank's device by ``rank_device``, the backend by
    ``backend_for``; ``threads`` CPU threads a rank) and return the ranks'
    results in rank order.

    A collective or message that waits longer than ``pg_timeout`` seconds
    raises in its rank; when any rank fails, the others are stopped and the
    error of the rank that failed first is raised here as a RuntimeError
    with its traceback; after ``timeout`` seconds every rank is stopped and
    TimeoutError is raised.
    """
    backend = backend_for(device, world)
    dev = torch.device(device)
    how = ("CUDA tensors staged through pinned host buffers"
           if backend == "gloo" and dev.type == "cuda" else
           "one card a rank" if backend == "nccl" else "CPU tensors")
    print(f"[dist] backend={backend} world={world} device={dev.type} "
          f"({how})", file=sys.stderr, flush=True)
    # the ranks' BLAS pools: a spawned rank reads these when it imports
    # numpy (an unset pool takes every core in each rank)
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    with tempfile.TemporaryDirectory(prefix="pamg-dist-") as tmp:
        os.environ.update({k: str(threads) for k in _THREAD_VARS})
        try:
            ctx = mp.start_processes(
                _rank_main, args=(fn, world, str(dev), backend, tmp, args,
                                  pg_timeout, threads),
                nprocs=world, join=False, start_method="spawn")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return _join(ctx, world, tmp, timeout)


def _join(ctx, world: int, tmp: str, timeout: float) -> list:
    """Wait for the ranks until ``timeout``; stop them all on a failure
    or at the deadline; the ranks' results in rank order."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"launch: {world} ranks did not finish "
                                   f"within {timeout:.0f} s")
    except mp.ProcessRaisedException as e:
        first = _first_error(tmp)
        if first is None:
            raise
        rank, trace = first
        raise RuntimeError(f"rank {rank} of {world} failed first:\n"
                           f"{trace}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _first_error(tmp: str):
    """(rank, traceback) of the earliest error a rank recorded in tmp, or
    None."""
    found = []
    for name in os.listdir(tmp):
        if name.startswith("error"):
            with open(os.path.join(tmp, name)) as f:
                stamp, trace = f.read().split("\n", 1)
            found.append((float(stamp), int(name[5:]), trace))
    return min(found)[1:] if found else None

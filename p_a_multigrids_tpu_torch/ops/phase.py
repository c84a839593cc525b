"""One relaxation phase of a level's block stencil: kernel K1.

A phase runs ``len(coefs)`` Jacobi-type rounds x <- x + coef_r * z(x), with
z(x) = D^-1 (b - A x) = bp - x - D^-1 (A - D) x, each round reading only
the previous round's state, plus (``want_z``) a trailing coef-0 round whose
z is returned.  With no coefs and ``want_z`` the single round gives
z = bp - D^-1 A x, so with bp = 0, A x = -D z (``SemiSolver._apply_t``).

On a CUDA tensor a whole phase is one launch of the hand-written kernel in
``csrc/phase.cu``, the port of the TPU kernels ``PhaseOperator._kernel``
(C <= 64 children per macro) and ``PhaseOperatorResident._kernel`` (C > 64:
n_split 4 and 5) of ``p_a_multigrids_tpu/ops/pallas_stencil.py``: one
kernel gathers children through an index table at any C, runs every round
with a barrier over its blocks between rounds, and keeps the coefficients
in shared memory where they fit (``phase_plan`` picks the tier).  The
kernel takes float32 (``k1_phase_f32``) and float64 (``k1_phase_f64``)
state, as the TPU kernels took the operator's dtype.  On a CPU
tensor the plain PyTorch version ``phase_reference`` runs instead; it is
also what the tests and ``chip_smoke.py`` hold the kernel against.  There
is no fallback: on a CUDA tensor the kernel builds and launches, or this
module raises.

An operator with a sanitizer site (``op.sanitizer``, set by
``utils.debugging.attach`` for the checked step) launches ``CHECKED``, the
checked build of the same source (``-DPAMG_CHECKED``: index and finite
checks into the sanitizer's error record), with the unchecked build's
launch plan; on the CPU its plain version's outputs are checked finite.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import torch

from ..utils import cuda_build, tracing
from .stencil import StencilOperator


# the TPU kernel PhaseOperatorResident took the levels with more children
DEEP_C = 64
# rounds one launch takes (csrc/phase.cu kMaxRounds); a longer phase is
# split into launches of at most this many rounds
MAX_ROUNDS = 64
MAX_THREADS = 1024
TIERS = ("small", "resident", "stream")
# the state dtypes kernel K1 takes: the library's entry and the ctypes
# scalar of the step sizes
DTYPES = {torch.float32: ("k1_phase_f32", ctypes.c_float),
          torch.float64: ("k1_phase_f64", ctypes.c_double)}


def resident_bytes(itemsize: int) -> int:
    """Bytes of a (child, macro) pair kept on chip with values of
    ``itemsize`` bytes: Fp (27 values), bp (3) and 10 int32 index locations
    (csrc/phase.cu kKeepVals, kKeepInts): 160 in float32, 280 in
    float64."""
    return 30 * itemsize + 40


def least_bytes(op: StencilOperator, itemsize: int = 4,
                planes: int = 4) -> int:
    """Bytes one K1 launch on op must move at least, whatever its rounds:
    one premultiplied 3x3 coupling block a face, Fp across the 3C - nb
    faces inside a macro and Xp across the nb strip faces (27 values a
    child; Fp of a strip face is zero and not counted, so at C = 1, where
    every face is a strip face, only Xp), and ``planes`` state planes of 3
    values a child: a phase reads x0 and bp and writes x and z (4); the
    zero-round apply z = -D^-1 A x needs only x in and z out (2), so the
    bp it reads and the x it writes are its waste, not its bound.  Index
    tables not counted."""
    return (27 + 3 * planes) * op.C * op.U * itemsize


def small_bytes(itemsize: int) -> int:
    """``resident_bytes`` plus the pair's state of two rounds (6 values),
    which the small tier keeps on chip too: 184 in float32, 328 in
    float64."""
    return 36 * itemsize + 40


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """How kernel K1 runs one level: the tier, ``grid`` blocks of
    ``threads``, ``slice`` (child, macro) pairs a block, ``smem`` bytes of
    dynamic shared memory."""
    tier: str
    grid: int
    threads: int
    slice: int
    smem: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def phase_plan(C: int, U: int, sm_count: int, smem_per_block: int,
               stream_blocks_per_sm: int, tier: str | None = None,
               itemsize: int = 4) -> PhasePlan:
    """The tier and launch shape of K1 for a (3, C, U) level of values of
    ``itemsize`` bytes (4: float32, 8: float64) on a card with
    ``sm_count`` SMs, ``smem_per_block`` bytes of opt-in shared memory a
    block and room for ``stream_blocks_per_sm`` 1024-thread streaming
    blocks an SM.  The first tier that fits, unless ``tier`` names one
    (ValueError when it does not fit):

    - small: one block, the whole level's Fp, bp, index offsets and state
      in its shared memory;
    - resident: one block per SM at most, each with its slice on chip;
    - stream: as many blocks as the card holds at once, everything read
      from L2 / device memory every round.
    """
    if tier not in (None,) + TIERS:
        raise ValueError(f"phase_plan: unknown tier {tier!r}")
    pairs = C * U
    small, resident = small_bytes(itemsize), resident_bytes(itemsize)
    round32 = lambda n: min(MAX_THREADS, 32 * _ceil(n, 32))
    if tier in (None, "small") and pairs * small <= smem_per_block:
        return PhasePlan("small", 1, round32(pairs), pairs, pairs * small)
    if tier in (None, "resident"):
        sl = _ceil(pairs, sm_count)
        if sl * resident <= smem_per_block:
            return PhasePlan("resident", _ceil(pairs, sl), round32(sl), sl,
                             sl * resident)
    if tier in (None, "stream"):
        sl = _ceil(pairs, sm_count * stream_blocks_per_sm)
        return PhasePlan("stream", _ceil(pairs, sl), MAX_THREADS, sl, 0)
    raise ValueError(f"phase_plan: C * U = {pairs} pairs do not fit the "
                     f"{tier} tier")


class PhaseKernel:
    """ctypes binding of ``k1_phase_f32`` and ``k1_phase_f64`` with their
    counts, which both dtypes share.

    ``launches`` grows by one for every kernel launch and nowhere else (one
    per phase of up to MAX_ROUNDS rounds), ``rounds`` by the rounds that
    launch ran, ``by_tier[tier]`` by one for a launch in that tier and
    ``least_bytes_by_tier[tier]`` by the least bytes that launch must move
    (``least_bytes``); ``launches_deep`` counts the
    launches on a level with C > ``DEEP_C`` children (the TPU's
    ``PhaseOperatorResident`` regime).  The library is
    built at the first launch (``cuda_build.load``).  A checked instance
    (``plan_from`` the unchecked one) builds the source with
    ``-DPAMG_CHECKED`` and plans its launches with the unchecked build's
    limits, so that both builds run the same plan."""

    # the launch counters (a CUDA graph's replay adds to them)
    COUNTERS = ("launches", "launches_deep", "rounds", "by_tier",
                "least_bytes_by_tier")

    def __init__(self, plan_from: "PhaseKernel | None" = None):
        self.checked = plan_from is not None
        self._plan_from = plan_from
        self.launches = 0
        self.launches_deep = 0
        self.rounds = 0
        self.by_tier = dict.fromkeys(TIERS, 0)
        self.least_bytes_by_tier = dict.fromkeys(TIERS, 0)
        self.build_info: dict | None = None
        self._lib = None
        self._limits: dict[tuple, tuple] = {}
        self._plans: dict[tuple, PhasePlan] = {}

    def reset(self):
        """Set every count to 0."""
        self.launches = self.launches_deep = self.rounds = 0
        self.by_tier = dict.fromkeys(TIERS, 0)
        self.least_bytes_by_tier = dict.fromkeys(TIERS, 0)

    def function(self, dtype: torch.dtype = torch.float32):
        """The library's entry for state of ``dtype`` (built and bound at
        the first call)."""
        if self._lib is None:
            lib, self.build_info = cuda_build.load(
                "phase", ("PAMG_CHECKED",) if self.checked else ())
            for name, scalar in DTYPES.values():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 11 + [
                    ctypes.POINTER(scalar)] + [ctypes.c_int] * 9 + [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                fn.restype = ctypes.c_int
            lib.k1_phase_limits.argtypes = [ctypes.c_int] + [
                ctypes.POINTER(ctypes.c_int)] * 3
            lib.k1_phase_limits.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, DTYPES[dtype][0])

    def limits(self, dev: int, itemsize: int) -> tuple:
        """(SMs, opt-in shared memory a block, streaming blocks an SM) of
        this build's kernel for values of ``itemsize`` bytes on card
        ``dev`` (``k1_phase_limits``)."""
        key = (dev, itemsize)
        if key not in self._limits:
            self.function()
            vals = [ctypes.c_int() for _ in range(3)]
            err = self._lib.k1_phase_limits(itemsize,
                                            *map(ctypes.byref, vals))
            if err != 0:
                raise RuntimeError(f"kernel K1: reading the card's "
                                   f"limits failed: CUDA error {err}")
            self._limits[key] = tuple(v.value for v in vals)
        return self._limits[key]

    def plan(self, op: StencilOperator, tier: str | None = None
             ) -> PhasePlan:
        """``phase_plan`` for op's level and dtype on op's card, cached
        per shape; a checked instance's is the unchecked build's plan."""
        dev = op.Fp_t.device.index or 0
        itemsize = op.Fp_t.element_size()
        if self._plan_from is not None:
            plan = self._plan_from.plan(op, tier)
            own = self.limits(dev, itemsize)[2]
            base = self._plan_from.limits(dev, itemsize)[2]
            if plan.tier == "stream" and own < base:
                raise RuntimeError(
                    f"kernel K1, checked build: {own} streaming blocks fit "
                    f"an SM, the unchecked build's plan needs {base}")
            return plan
        key = (dev, op.C, op.U, tier, itemsize)
        if key not in self._plans:
            self._plans[key] = phase_plan(op.C, op.U,
                                          *self.limits(dev, itemsize),
                                          tier=tier, itemsize=itemsize)
        return self._plans[key]

    def launch(self, op: StencilOperator, x, bp, buf0, buf1, z_out,
               coefs, plan: PhasePlan, stream: int, nbytes: int):
        """Launch one phase of len(coefs) rounds (a ctypes array of the
        state's scalar) on ``stream``: round r reads x (r = 0) or the
        buffer round r - 1 wrote, writes buf0 (r even) or buf1 (r odd), and
        the last round writes z_out unless it is None; ``nbytes`` is the
        least bytes the launch must move.  A checked instance records its
        first fault in the error record of op's sanitizer site."""
        fn = self.function(x.dtype)
        record, site = None, 0
        if self.checked:
            record = op.sanitizer.sanitizer.record.data_ptr()
            site = op.sanitizer.index
        err = fn(x.data_ptr(), bp.data_ptr(), op.Fp_t.data_ptr(),
                 op.Xp_t.data_ptr(), op.intra_rows.data_ptr(),
                 op.slot_ptr.data_ptr(), op.slot_idx.data_ptr(),
                 op.src_cu.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
                 None if z_out is None else z_out.data_ptr(), coefs,
                 len(coefs), op.C, op.U, op.nb, TIERS.index(plan.tier),
                 plan.grid, plan.threads, plan.slice, plan.smem, stream,
                 record, site)
        if err != 0:
            raise RuntimeError(f"kernel K1 (phase, {plan.tier} tier, "
                               f"{plan.grid} x {plan.threads}) launch failed:"
                               f" CUDA error {err}")
        self.launches += 1
        self.rounds += len(coefs)
        self.by_tier[plan.tier] += 1
        self.least_bytes_by_tier[plan.tier] += nbytes
        if op.C > DEEP_C:
            self.launches_deep += 1


KERNEL = PhaseKernel()
# the checked build, which the checked step launches (utils/debugging.py)
CHECKED = PhaseKernel(plan_from=KERNEL)


# the lists ``watch`` opened: each call of ``phase_on_tier`` that launches
# K1 appends its least bytes to every one
_WATCHES: list = []


@contextlib.contextmanager
def watch():
    """Yields a list to which every call of ``phase_on_tier`` made inside
    the block that launches K1 appends the least bytes it must move
    (``least_bytes``: the zero-round apply 2 state planes, a phase 3, and
    4 with z), as a CUDA graph's capture records its K1 calls
    (``models/semi``)."""
    calls: list = []
    _WATCHES.append(calls)
    try:
        yield calls
    finally:
        _WATCHES.remove(calls)


def _round_coefs(coefs, want_z: bool, dtype: torch.dtype) -> list[float]:
    """Per-round step sizes cast to the state dtype (the trailing 0 is the
    z round), as the TPU kernel's coefficient array was."""
    tail = [0.0] if want_z else []
    return torch.tensor(list(coefs) + tail, dtype=torch.float64
                        ).to(dtype).tolist()


@functools.lru_cache(maxsize=256)
def _launch_rounds(coefs: tuple, want_z: bool, dtype: torch.dtype) -> tuple:
    """The step sizes of a phase on the card in the state's ``dtype``, as
    ctypes arrays (c_float or c_double) of at most MAX_ROUNDS rounds each,
    one a launch; cached, since a cycle runs the same few phases again and
    again."""
    rounds = _round_coefs(coefs, want_z, dtype)
    scalar = DTYPES[dtype][1]
    return tuple((scalar * len(rounds[k:k + MAX_ROUNDS]))(
        *rounds[k:k + MAX_ROUNDS]) for k in range(0, len(rounds), MAX_ROUNDS))


def _check(op: StencilOperator, x_t, bp_t):
    shape = (3, op.C, op.U)
    for name, t in (("x", x_t), ("bp", bp_t)):
        if tuple(t.shape) != shape:
            raise ValueError(f"phase: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"phase: {name} is not contiguous")
        if t.device != op.Fp_t.device or t.dtype != op.Fp_t.dtype:
            raise ValueError(
                f"phase: {name} is {t.dtype} on {t.device}, the operator "
                f"{op.Fp_t.dtype} on {op.Fp_t.device}")


def phase_reference(op: StencilOperator, x_t, bp_t, coefs,
                    want_z: bool = True):
    """Plain PyTorch phase: the same rounds as kernel K1, one ``op._z`` each.

    Returns (x, z), z = D^-1 (b - A x) at the returned x when want_z, else
    None."""
    x, z = x_t, None
    for coef in _round_coefs(coefs, want_z, x_t.dtype):
        z = op._z(x, bp_t)
        x = x + coef * z
    return x, (z if want_z else None)


def phase(op: StencilOperator, x_t, bp_t, coefs, want_z: bool = True):
    """Run one relaxation phase on ``op``'s device.

    Args:
      x_t:   (3, C, U) state, contiguous
      bp_t:  (3, C, U) premultiplied right-hand side D^-1 (b - c_aff)
      coefs: per-round step sizes (1/root_k or omega)
      want_z: add the coef-0 round and return its z; False returns None
    Returns (x_new, z).  CPU tensors run ``phase_reference``; CUDA tensors
    (float32 or float64) launch kernel K1 once, in the tier ``phase_plan``
    picks.
    """
    return phase_on_tier(op, x_t, bp_t, coefs, want_z, None)


def phase_on_tier(op: StencilOperator, x_t, bp_t, coefs, want_z: bool,
                  tier: str | None):
    """``phase`` with K1's tier forced to ``tier`` (None: ``phase_plan``'s
    choice); a tier the level does not fit raises ValueError.  The launch
    loop (on the CPU, ``phase_reference``) is the span ``pamg.k1``."""
    _check(op, x_t, bp_t)
    site = op.sanitizer
    if x_t.device.type == "cpu":
        with tracing.span("pamg.k1"):
            x, z = phase_reference(op, x_t, bp_t, coefs, want_z)
        if site is not None:
            site.check_finite(1, x, z)
        return x, z
    if x_t.device.type != "cuda":
        raise ValueError(f"phase: unsupported device {x_t.device}")
    if x_t.dtype not in DTYPES:
        raise TypeError(f"kernel K1 takes float32 or float64 state, got "
                        f"{x_t.dtype}")
    chunks = _launch_rounds(tuple(map(float, coefs)), want_z, x_t.dtype)
    if not chunks:
        return x_t, None
    with torch.cuda.device(x_t.device):
        stream = torch.cuda.current_stream(x_t.device).cuda_stream
        kernel = KERNEL if site is None else CHECKED
        plan = kernel.plan(op, tier)
        with tracing.span("pamg.k1"):
            src, z = launch_chunks(kernel, op, x_t, bp_t, chunks,
                                   bool(len(coefs)), want_z, plan, stream)
    if _WATCHES:
        planes = 3 + int(want_z) if len(coefs) else 2
        nbytes = least_bytes(op, x_t.element_size(), planes)
        for calls in _WATCHES:
            calls.append(nbytes)
    return src, z


def launch_chunks(kernel: PhaseKernel, op: StencilOperator, x_t, bp_t,
                  chunks: tuple, rounds: bool, want_z: bool,
                  plan: PhasePlan, stream: int):
    """The launches of one phase on ``stream``, one for each chunk of its
    step sizes (``_launch_rounds``), each reading the buffer the one before
    wrote, and each given the least bytes it must move (``least_bytes``):
    the zero-round apply (``rounds`` False) x in and z out, a phase's
    launch x0, bp and x, and z in its last launch.  Returns (x, z), z
    None without ``want_z``."""
    itemsize = x_t.element_size()
    # the two ping-pong buffers (one for a single round) and z, in one
    # allocation
    n_bufs = min(2, sum(map(len, chunks)))
    out = torch.empty((n_bufs + int(want_z),) + tuple(x_t.shape),
                      dtype=x_t.dtype, device=x_t.device)
    bufs, z = list(out[:n_bufs]), (out[n_bufs] if want_z else None)
    src = x_t
    for k, chunk in enumerate(chunks):
        # the launch writes buf0 first: never the buffer it reads
        b0, b1 = bufs[0], bufs[-1]
        if src is b0:
            b0, b1 = b1, b0
        last = k == len(chunks) - 1
        planes = 3 + int(want_z and last) if rounds else 2
        kernel.launch(op, src, bp_t, b0, b1, z if last else None, chunk,
                      plan, stream, least_bytes(op, itemsize, planes))
        src = b0 if len(chunk) % 2 else b1
    return src, z

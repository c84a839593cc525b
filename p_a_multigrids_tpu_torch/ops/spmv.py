"""Fixed-degree 3x3 block-row SpMV in the transposed layout: kernel K2.

A ``RowOp`` holds one padded block-row operator: row n couples to block
columns ``cols[n, d]`` through dense 3x3 blocks ``vals[n, d]`` (zero blocks
pad short rows), and maps a transposed vector (3, S) to (3, N):

    y[i, n] = sum_d sum_j vals[n, d, i, j] * x[j, cols[n, d]]

Square for an SA level operator, rectangular for a transfer.  On a CUDA
tensor every application is one launch of the hand-written kernel in
``csrc/spmv.cu`` (the port of the TPU kernel ``PallasSpMV._kernel``,
``p_a_multigrids_tpu/ops/pallas_bsr.py``), in the variant ``rowop_plan``
picks from the operator's width: one thread per row for narrow operators,
a group of lanes per row for wide ones, in float32 (``k2_rowop_f32``) or
float64 (``k2_rowop_f64``), as the TPU kernel took the dtype of its
values.  On a CPU tensor
the plain PyTorch version ``rowop_reference`` runs instead; it is also what
the tests and ``chip_smoke.py`` hold the kernel against.  There is no
fallback: on a CUDA tensor the kernel builds and launches, or this module
raises.

An operator with a sanitizer site (``op.sanitizer``, set by
``utils.debugging.attach`` for the checked step) launches ``CHECKED``, the
checked build of the same source (``-DPAMG_CHECKED``), in the same variant;
on the CPU its plain version's output is checked finite.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from ..utils import cuda_build, tracing

# lane groups for operators of LANES_MIN_D to lanes_max_d(itemsize) slots a
# row: on the H100 they beat one thread a row from D = 8 on (32,768 x 13:
# 5.29 us against 6.33) and lose below (32,768 x 5: 4.12 against 3.33)
LANES_MIN_D = 8
# the state dtypes kernel K2 takes, by the name of their entry
DTYPES = {torch.float32: "k2_rowop_f32", torch.float64: "k2_rowop_f64"}


def lanes_max_d(itemsize: int) -> int:
    """The widest row the lanes variant takes: above it the slot sums of a
    block's 4 rows of 32 lanes (3 values of ``itemsize`` bytes a slot)
    outgrow 48 KB of shared memory, so no launch needs the opt-in
    attribute: 1,024 slots in float32, 512 in float64."""
    return 48 * 1024 // (4 * 3 * itemsize)


def rowop_plan(n_out: int, D: int, variant: str | None = None,
               itemsize: int = 4) -> tuple[str, int, int]:
    """(variant, lanes, Dp) of K2 for an operator of D slots a row of
    values of ``itemsize`` bytes: ("thread", 1, D), or ("lanes", G, Dp) with
    D padded to Dp, a multiple of 4 (the 16-byte loads), and G = 4, 8, 16
    or 32 lanes a row, the power of two that gives each lane about one quad
    of slots.  ``variant`` forces one; None chooses by the shape."""
    if variant is None:
        variant = ("lanes" if LANES_MIN_D <= D <= lanes_max_d(itemsize)
                   else "thread")
    if variant == "thread":
        return "thread", 1, D
    if variant != "lanes":
        raise ValueError(f"rowop_plan: unknown variant {variant!r}")
    quads = max(1, -(-D // 4))
    return "lanes", min(32, max(4, 1 << (quads - 1).bit_length())), 4 * quads


class SpMVKernel:
    """ctypes binding of ``k2_rowop_f32`` and ``k2_rowop_f64`` with their
    launch count, which both dtypes share.

    ``launches`` grows by one for every kernel launch and nowhere else; the
    library is built at the first launch (``cuda_build.load``), with
    ``-DPAMG_CHECKED`` for a ``checked`` instance."""

    # the launch counters (a CUDA graph's replay adds to them)
    COUNTERS = ("launches",)

    def __init__(self, checked: bool = False):
        self.checked = checked
        self.launches = 0
        self.build_info: dict | None = None
        self._lib = None

    def function(self, dtype: torch.dtype = torch.float32):
        """The library's entry for values of ``dtype`` (built and bound at
        the first call)."""
        if self._lib is None:
            lib, self.build_info = cuda_build.load(
                "spmv", ("PAMG_CHECKED",) if self.checked else ())
            for name in DTYPES.values():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                fn.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, DTYPES[dtype])

    def launch(self, op: "RowOp", x_t, y_t, stream: int):
        """y_t <- op(x_t) on ``stream``; a checked instance records its
        first fault in the error record of op's sanitizer site."""
        fn = self.function(x_t.dtype)
        record, site = None, 0
        if self.checked:
            record = op.sanitizer.sanitizer.record.data_ptr()
            site = op.sanitizer.index
        err = fn(op.cols_t.data_ptr(), op.vals_t.data_ptr(), x_t.data_ptr(),
                 y_t.data_ptr(), op.n_out, op.Dp, op.n_src, op.lanes, stream,
                 record, site)
        if err != 0:
            raise RuntimeError(f"kernel K2 (block-row SpMV, {op.variant}) "
                               f"launch failed: CUDA error {err}")
        self.launches += 1


KERNEL = SpMVKernel()
# the checked build, which the checked step launches (utils/debugging.py)
CHECKED = SpMVKernel(checked=True)


class RowOp(nn.Module):
    """One padded block-row operator on a device.

    ``variant`` (``rowop_plan``'s choice unless given) fixes the layout of
    the buffers: "thread" stores ``cols_t`` (D, N) int32 and ``vals_t``
    (D, 3i, 3j, N), row index fastest, so that threads of neighbouring rows
    read neighbouring addresses; "lanes" stores ``cols_t`` (N, Dp) and
    ``vals_t`` (N, 3i, 3j, Dp), the slots of a row consecutive, with D
    padded to Dp by zero blocks on the row's first column.  ``tables()``
    reads either as (D, N) / (D, 3, 3, N).  ``n_src`` is the number of
    source block rows S; every column index lies in [0, S).
    """

    def __init__(self, cols: np.ndarray, vals: np.ndarray, n_src: int,
                 dtype: torch.dtype, device, variant: str | None = None):
        super().__init__()
        cols = np.asarray(cols)
        N, D = cols.shape
        if np.shape(vals) != (N, D, 3, 3):
            raise ValueError(f"RowOp: vals shape {np.shape(vals)} does not "
                             f"match cols {cols.shape} x (3, 3)")
        if N and (cols.min() < 0 or cols.max() >= n_src):
            raise ValueError(f"RowOp: column index outside [0, {n_src})")
        self.n_out, self.D, self.n_src = int(N), int(D), int(n_src)
        # the checked step's site of this operator (utils.debugging.attach)
        self.sanitizer = None
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.variant, self.lanes, self.Dp = rowop_plan(N, D, variant,
                                                       itemsize)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        vals = np.asarray(vals, np_dtype)
        if self.variant == "thread":
            cols_t, vals_t = cols.T, vals.transpose(1, 2, 3, 0)
        else:
            pad = self.Dp - D
            first = cols[:, :1] if D else np.zeros((N, 1), cols.dtype)
            cols_t = np.concatenate([cols, np.repeat(first, pad, 1)], 1)
            vals_t = np.concatenate(
                [vals, np.zeros((N, pad, 3, 3), np_dtype)], 1
            ).transpose(0, 2, 3, 1)
        self.register_buffer("cols_t", torch.tensor(
            np.ascontiguousarray(cols_t.astype(np.int32)), device=device))
        self.register_buffer("vals_t", torch.tensor(
            np.ascontiguousarray(vals_t), device=device))

    def tables(self):
        """(cols (D, N), vals (D, 3, 3, N)): views of the stored tables in
        the thread layout, whatever the variant (D is Dp for "lanes")."""
        if self.variant == "thread":
            return self.cols_t, self.vals_t
        return self.cols_t.T, self.vals_t.permute(3, 1, 2, 0)

    def forward(self, x_t):
        """``rowop``, the span ``pamg.k2``."""
        with tracing.span("pamg.k2"):
            return rowop(self, x_t)


def rowop_reference(cols_t, vals_t, x_t):
    """Plain PyTorch block-row SpMV, (3, S) -> (3, N): one gather and one
    einsum over tables in the thread layout (cols_t (D, N), vals_t
    (D, 3, 3, N), as ``RowOp.tables()`` gives them)."""
    xg = x_t[:, cols_t.long()]                            # (3j, D, N)
    return torch.einsum("dijn,jdn->in", vals_t, xg).contiguous()


def _check(op: RowOp, x_t):
    if tuple(x_t.shape) != (3, op.n_src):
        raise ValueError(f"rowop: x has shape {tuple(x_t.shape)}, expected "
                         f"{(3, op.n_src)}")
    if not x_t.is_contiguous():
        raise ValueError("rowop: x is not contiguous")
    if x_t.device != op.vals_t.device or x_t.dtype != op.vals_t.dtype:
        raise ValueError(f"rowop: x is {x_t.dtype} on {x_t.device}, the "
                         f"operator {op.vals_t.dtype} on {op.vals_t.device}")


def rowop(op: RowOp, x_t):
    """y = op x on op's device: (3, S) -> (3, N).

    CPU tensors run ``rowop_reference``; CUDA tensors (float32 or float64)
    launch kernel K2 once.
    """
    _check(op, x_t)
    if x_t.device.type == "cpu":
        y_t = rowop_reference(*op.tables(), x_t)
        if op.sanitizer is not None:
            op.sanitizer.check_finite(2, y_t)
        return y_t
    if x_t.device.type != "cuda":
        raise ValueError(f"rowop: unsupported device {x_t.device}")
    if x_t.dtype not in DTYPES:
        raise TypeError(f"kernel K2 takes float32 or float64 vectors, got "
                        f"{x_t.dtype}")
    y_t = torch.empty((3, op.n_out), dtype=x_t.dtype, device=x_t.device)
    with torch.cuda.device(x_t.device):
        stream = torch.cuda.current_stream(x_t.device).cuda_stream
        (KERNEL if op.sanitizer is None else CHECKED).launch(op, x_t, y_t,
                                                             stream)
    return y_t

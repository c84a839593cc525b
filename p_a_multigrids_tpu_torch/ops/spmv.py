"""Fixed-degree 3x3 block-row SpMV in the transposed layout: kernel K2.

A ``RowOp`` holds one padded block-row operator: row n couples to block
columns ``cols[n, d]`` through dense 3x3 blocks ``vals[n, d]`` (zero blocks
pad short rows), and maps a transposed vector (3, S) to (3, N):

    y[i, n] = sum_d sum_j vals[n, d, i, j] * x[j, cols[n, d]]

Square for an SA level operator, rectangular for a transfer.  On a CUDA
tensor every application is one launch of the hand-written kernel in
``csrc/spmv.cu`` (the port of the TPU kernel ``PallasSpMV._kernel``,
``p_a_multigrids_tpu/ops/pallas_bsr.py``).  On a CPU tensor the plain
PyTorch version ``rowop_reference`` runs instead; it is also what the tests
and ``chip_smoke.py`` hold the kernel against.  There is no fallback: on a
CUDA tensor the kernel builds and launches, or this module raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from ..utils import cuda_build


class SpMVKernel:
    """ctypes binding of ``k2_rowop`` with its launch count.

    ``launches`` grows by one for every kernel launch and nowhere else; the
    library is built at the first launch (``cuda_build.load``)."""

    def __init__(self):
        self.launches = 0
        self.build_info: dict | None = None
        self._fn = None

    def function(self):
        if self._fn is None:
            lib, self.build_info = cuda_build.load("spmv")
            fn = lib.k2_rowop
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, op: "RowOp", x_t, y_t, stream: int):
        """y_t <- op(x_t) on ``stream``."""
        fn = self.function()
        err = fn(op.cols_t.data_ptr(), op.vals_t.data_ptr(), x_t.data_ptr(),
                 y_t.data_ptr(), op.n_out, op.D, op.n_src, stream)
        if err != 0:
            raise RuntimeError(f"kernel K2 (block-row SpMV) launch failed: "
                               f"CUDA error {err}")
        self.launches += 1


KERNEL = SpMVKernel()


class RowOp(nn.Module):
    """One padded block-row operator on a device.

    Buffers: ``cols_t`` (D, N) int32 and ``vals_t`` (D, 3i, 3j, N), both
    with the row index fastest, so that threads of neighbouring rows read
    neighbouring addresses.  ``n_src`` is the number of source block rows
    S; every column index lies in [0, S).
    """

    def __init__(self, cols: np.ndarray, vals: np.ndarray, n_src: int,
                 dtype: torch.dtype, device):
        super().__init__()
        cols = np.asarray(cols)
        N, D = cols.shape
        if np.shape(vals) != (N, D, 3, 3):
            raise ValueError(f"RowOp: vals shape {np.shape(vals)} does not "
                             f"match cols {cols.shape} x (3, 3)")
        if N and (cols.min() < 0 or cols.max() >= n_src):
            raise ValueError(f"RowOp: column index outside [0, {n_src})")
        self.n_out, self.D, self.n_src = int(N), int(D), int(n_src)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.register_buffer("cols_t", torch.tensor(
            np.ascontiguousarray(cols.T.astype(np.int32)), device=device))
        self.register_buffer("vals_t", torch.tensor(np.ascontiguousarray(
            np.asarray(vals, np_dtype).transpose(1, 2, 3, 0)),
            device=device))

    def forward(self, x_t):
        return rowop(self, x_t)


def rowop_reference(cols_t, vals_t, x_t):
    """Plain PyTorch block-row SpMV, (3, S) -> (3, N): one gather and one
    einsum over the transposed tables (cols_t (D, N), vals_t (D, 3, 3, N))."""
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

    CPU tensors run ``rowop_reference``; CUDA tensors (float32 only) launch
    kernel K2 once.
    """
    _check(op, x_t)
    if x_t.device.type == "cpu":
        return rowop_reference(op.cols_t, op.vals_t, x_t)
    if x_t.device.type != "cuda":
        raise ValueError(f"rowop: unsupported device {x_t.device}")
    if x_t.dtype != torch.float32:
        raise TypeError(f"kernel K2 takes float32 vectors, got {x_t.dtype}")
    y_t = torch.empty((3, op.n_out), dtype=x_t.dtype, device=x_t.device)
    with torch.cuda.device(x_t.device):
        stream = torch.cuda.current_stream(x_t.device).cuda_stream
        KERNEL.launch(op, x_t, y_t, stream)
    return y_t

"""Fixed-degree block-sparse matrices (ELL layout) for DG operators, port of
the JAX package's ``ops/bsr.py``.

Every block row holds exactly K = 1 + nface column blocks (self first, then
faces, padded with zero blocks pointing at the row itself), so the host
assembly is plain array construction (``build``).  On a device the matrix
is a ``spmv.RowOp`` (``BSR.rowop``): y = A x on a transposed (3, E) vector
is one launch of kernel K2 on a CUDA tensor, at every size (the TPU path's
fallback to a gather when its Pallas layout did not fit has no counterpart
here).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .spmv import RowOp


class BSR(NamedTuple):
    """Block row e couples to block columns cols[e, :] with blocks vals
    (host numpy)."""
    cols: np.ndarray   # (E, K) int32, padded entries point at row e
    vals: np.ndarray   # (E, K, b, b)

    @property
    def num_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def block_size(self) -> int:
        return self.vals.shape[-1]

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x with x (E, 3) -> (E, 3) on x's device and dtype, through
        ``rowop`` (one K2 launch on a CUDA tensor)."""
        op = self.rowop(x.dtype, x.device)
        return op(x.T.contiguous()).T.contiguous()

    def diag_blocks(self) -> np.ndarray:
        """(E, b, b) diagonal blocks (slot 0 by convention)."""
        return self.vals[:, 0]

    def diagonal(self) -> np.ndarray:
        """(E, b) scalar diagonal."""
        return np.diagonal(self.diag_blocks(), axis1=-2, axis2=-1)

    def rowop(self, dtype: torch.dtype, device) -> RowOp:
        """The matrix on ``device`` as a square K2 operator (3, E) -> (3, E),
        E = num_rows."""
        return RowOp(self.cols, self.vals, self.num_rows, dtype, device)

    def to_dense(self, device="cuda") -> torch.Tensor:
        """The dense (E*b, E*b) matrix in ``vals``' dtype on ``device`` (the
        card unless the caller asks for the CPU): ``to_dense`` of the
        ``rowop``, one scatter-add of the blocks."""
        return to_dense(self.rowop(getattr(torch, self.vals.dtype.name),
                                   device))


def build(diag: np.ndarray, face_blocks: np.ndarray,
          neigh: np.ndarray) -> BSR:
    """Assemble from a diagonal block and per-face neighbor blocks.

    Args:
      diag:        (E, b, b)
      face_blocks: (E, nface, b, b), coupling to the neighbor across each
                   face (zeroed here where there is none)
      neigh:       (E, nface) int, -1 for boundary faces.
    """
    E = neigh.shape[0]
    neigh = np.asarray(neigh)
    self_col = np.arange(E, dtype=neigh.dtype)[:, None]
    cols = np.concatenate([self_col, np.where(neigh < 0, self_col, neigh)],
                          axis=1)
    mask = np.concatenate([np.ones((E, 1), bool), neigh >= 0], axis=1)
    vals = np.concatenate([diag[:, None], face_blocks], axis=1)
    vals = np.where(mask[:, :, None, None], vals, 0.0).astype(diag.dtype)
    return BSR(cols=cols.astype(np.int32), vals=vals)


def to_dense_numpy(A: BSR) -> np.ndarray:
    """Dense (E*b, E*b) matrix for verification / direct solves."""
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    E, K = cols.shape
    b = vals.shape[-1]
    dense = np.zeros((E, b, E, b), vals.dtype)
    for e in range(E):
        for k in range(K):
            dense[e, :, cols[e, k], :] += vals[e, k]
    return dense.reshape(E * b, E * b)


def to_dense(op: RowOp) -> torch.Tensor:
    """The dense (3E, 3E) matrix of a square 3x3-block RowOp on its own
    device and dtype, rows and columns in the flat order e*3 + i, built by
    one index_add_ of its blocks (no host loop)."""
    cols, vals = op.tables()                          # (D, E), (D, 3, 3, E)
    E, dev = op.n_out, vals.device
    e = torch.arange(E, device=dev)
    i = torch.arange(3, device=dev)
    # flat index of (row e*3 + i, column cols*3 + j), shape (D, 3i, 3j, E)
    idx = (((e * 3)[None, None, None, :] + i[None, :, None, None]) * (3 * E)
           + (cols.long() * 3)[:, None, None, :] + i[None, None, :, None])
    dense = torch.zeros(9 * E * E, dtype=vals.dtype, device=dev)
    dense.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return dense.reshape(3 * E, 3 * E)

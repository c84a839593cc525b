"""Layout conversion between the standard (U, C, 3) state and the
transposed (3, C, U) layout the solver runs in (from the JAX package's
``ops/fused.py``)."""

from __future__ import annotations

import torch


def to_t(T: torch.Tensor) -> torch.Tensor:
    """(U, C, n) -> (n, C, U), contiguous."""
    return T.permute(2, 1, 0).contiguous()


def from_t(Tt: torch.Tensor) -> torch.Tensor:
    """(n, C, U) -> (U, C, n), contiguous."""
    return Tt.permute(2, 1, 0).contiguous()

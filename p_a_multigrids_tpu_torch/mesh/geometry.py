"""Triangle geometry on the host (the numpy part of the JAX package's
``mesh/geometry.py``)."""

from __future__ import annotations

import numpy as np


def tri_area(x: np.ndarray) -> np.ndarray:
    """Signed area of triangles, x: (..., 2, 3)."""
    x1, y1 = x[..., 0, 0], x[..., 1, 0]
    x2, y2 = x[..., 0, 1], x[..., 1, 1]
    x3, y3 = x[..., 0, 2], x[..., 1, 2]
    return 0.5 * ((x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1))

"""Chebyshev smoothing schedule (from the JAX package's
``ops/smoothers.py``).  The smoothing itself runs as relaxation phases of
kernel K1 (``ops/phase.py``)."""

from __future__ import annotations

import numpy as np


def chebyshev_roots(lam_max: float, degree: int,
                    lower: float = 0.1) -> list[float]:
    """Chebyshev roots of the smoothing interval [lower*lam, lam] for the
    product-form sweep x <- x + (1/r_k) M^-1 (b - A x), interleaved
    large/small so intermediate amplification stays bounded in f32."""
    a_, b_ = lower * lam_max, lam_max
    ks = np.arange(1, degree + 1)
    roots = (0.5 * (b_ + a_)
             + 0.5 * (b_ - a_) * np.cos(np.pi * (2 * ks - 1) / (2 * degree)))
    order: list[float] = []
    lo, hi = 0, degree - 1
    while lo <= hi:
        order.append(float(roots[lo]))
        lo += 1
        if lo <= hi:
            order.append(float(roots[hi]))
            hi -= 1
    return order

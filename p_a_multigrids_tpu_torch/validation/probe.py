"""Point probes of DG fields, the VTK probe-filter replacement (numpy copy
of the JAX package's ``validation/probe.py``).

The reference validates by probing the latest VTU along a line with VTK's
probe filter (Check_thermal_analytical_validation.py:63-132, My_version
.py).  Here the DG solution is sampled directly: locate the element
containing each probe point (barycentric test) and evaluate its P1
polynomial.
"""

from __future__ import annotations

import numpy as np


def sample_points(coords: np.ndarray, values: np.ndarray,
                  pts: np.ndarray) -> np.ndarray:
    """Evaluate a DG-P1 field at arbitrary points.

    Args:
      coords: (E, 2, 3) element node coordinates
      values: (E, 3) nodal values
      pts:    (P, 2) probe points
    Returns (P,) sampled values (NaN outside the mesh).
    """
    E = coords.shape[0]
    P = pts.shape[0]
    x1, y1 = coords[:, 0, 0], coords[:, 1, 0]
    x2, y2 = coords[:, 0, 1], coords[:, 1, 1]
    x3, y3 = coords[:, 0, 2], coords[:, 1, 2]
    det = (x1 - x3) * (y2 - y3) - (x2 - x3) * (y1 - y3)      # (E,)

    out = np.full((P,), np.nan)
    px, py = pts[:, 0], pts[:, 1]
    # barycentric coordinates of every point in every element: P x E can be
    # large; loop over probe points (P is small for line probes)
    for p in range(P):
        l1 = ((y2 - y3) * (px[p] - x3) + (x3 - x2) * (py[p] - y3)) / det
        l2 = ((y3 - y1) * (px[p] - x3) + (x1 - x3) * (py[p] - y3)) / det
        l3 = 1.0 - l1 - l2
        tol = 1e-9
        inside = (l1 >= -tol) & (l2 >= -tol) & (l3 >= -tol)
        idx = np.flatnonzero(inside)
        if idx.size == 0:
            continue
        e = idx[0]
        out[p] = (l1[e] * values[e, 0] + l2[e] * values[e, 1]
                  + l3[e] * values[e, 2])
    return out


def line_probe(coords: np.ndarray, values: np.ndarray, y: float,
               x0: float, x1: float, n: int = 202):
    """Sample along a horizontal line (the reference probes 202 points at
    y=0.0333, Check_thermal_analytical_validation.py:63-73)."""
    xs = np.linspace(x0, x1, n)
    pts = np.stack([xs, np.full_like(xs, y)], axis=1)
    return xs, sample_points(coords, values, pts)

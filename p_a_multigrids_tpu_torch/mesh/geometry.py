"""Element geometry on the host (numpy copies of the JAX package's
``mesh/geometry.py``: the triangle area, and the quad Jacobians and edge
geometry of mode 1)."""

from __future__ import annotations

import numpy as np


def tri_area(x: np.ndarray) -> np.ndarray:
    """Signed area of triangles, x: (..., 2, 3)."""
    x1, y1 = x[..., 0, 0], x[..., 1, 0]
    x2, y2 = x[..., 0, 1], x[..., 1, 1]
    x3, y3 = x[..., 0, 2], x[..., 1, 2]
    return 0.5 * ((x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1))


def det_snlx(xsl: np.ndarray, snlx: np.ndarray, sweight: np.ndarray,
             approx_norm: np.ndarray):
    """Batched edge geometry.

    Args:
      xsl:         (..., 2, snloc) edge endpoint coordinates
      snlx:        (sngi, 1, snloc) surface local derivatives
      sweight:     (sngi,)
      approx_norm: (..., 2) any outward vector, used only for the sign
    Returns sdetwei (..., sngi) and the unit outward normals snorm (...,
    sngi, 2).
    """
    t = np.einsum("gl,...bl->...gb", snlx[:, 0, :], xsl)
    detj = np.sqrt(np.sum(t * t, axis=-1))
    sdetwei = detj * sweight
    # the tangent turned by 90 degrees: n = (ty, -tx) / |t|
    n = np.stack([t[..., 1], -t[..., 0]], axis=-1) / detj[..., None]
    sign = np.sign(np.sum(n * approx_norm[..., None, :], axis=-1))
    sign = np.where(sign == 0, 1.0, sign)
    return sdetwei, n * sign[..., None]


def quad_det_nlx(x_loc: np.ndarray, nlx: np.ndarray, weight: np.ndarray):
    """Batched quad Jacobians: returns detwei (..., ngi) with the full
    |det J| weight (unit-square reference measure), the physical
    derivatives nx (..., ngi, 2, nloc) and the inverse Jacobians."""
    jac = np.einsum("gal,...bl->...gab", nlx, x_loc)
    detj = jac[..., 0, 0] * jac[..., 1, 1] - jac[..., 0, 1] * jac[..., 1, 0]
    detwei = np.abs(detj) * weight
    inv = np.stack([
        np.stack([jac[..., 1, 1], -jac[..., 0, 1]], axis=-1),
        np.stack([-jac[..., 1, 0], jac[..., 0, 0]], axis=-1),
    ], axis=-2) / detj[..., None, None]
    nx = np.einsum("...gab,gbl->...gal", inv, nlx)
    return detwei, nx, inv

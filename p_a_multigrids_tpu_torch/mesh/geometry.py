"""Element geometry on the host (numpy copies of the JAX package's
``mesh/geometry.py``)."""

from __future__ import annotations

import numpy as np


def tri_area(x: np.ndarray) -> np.ndarray:
    """Signed area of triangles, x: (..., 2, 3)."""
    x1, y1 = x[..., 0, 0], x[..., 1, 0]
    x2, y2 = x[..., 0, 1], x[..., 1, 1]
    x3, y3 = x[..., 0, 2], x[..., 1, 2]
    return 0.5 * ((x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1))


def tri_det_nlx(x_loc: np.ndarray, nlx: np.ndarray, weight: np.ndarray):
    """Batched triangle Jacobians.

    Args:
      x_loc:  (..., 2, nloc) vertex coordinates
      nlx:    (ngi, 2, nloc) local derivatives of the shape functions
      weight: (ngi,) quadrature weights
    Returns detwei (..., ngi) = 0.5 |det J| w, the physical derivatives nx
    (..., ngi, 2, nloc) and the inverse Jacobians (..., ngi, 2, 2).
    """
    jac = np.einsum("gal,...bl->...gab", nlx, x_loc)
    detj = jac[..., 0, 0] * jac[..., 1, 1] - jac[..., 0, 1] * jac[..., 1, 0]
    detwei = 0.5 * np.abs(detj) * weight
    inv = np.stack([
        np.stack([jac[..., 1, 1], -jac[..., 0, 1]], axis=-1),
        np.stack([-jac[..., 1, 0], jac[..., 0, 0]], axis=-1),
    ], axis=-2) / detj[..., None, None]
    nx = np.einsum("...gab,gbl->...gal", inv, nlx)
    return detwei, nx, inv


def semi_level_scalings(detwei_macro, nx_macro, sdetwei_macro, n_split: int,
                        multi_levels: int):
    """Per-level geometry of the nested 4**s hierarchy: a child at split
    depth s = n_split - ilevel + 1 (ilevel 1 the finest) is a scaled copy
    of its macro triangle, so detwei / 4**s, nx * 2**s and sdetwei / 2**s.
    Returns a list (index 0 the finest) of dicts of the scaled arrays."""
    out = []
    for ilevel in range(1, multi_levels + 1):
        s = n_split - ilevel + 1
        out.append(dict(detwei=detwei_macro / (4.0 ** s),
                        nx=nx_macro * (2.0 ** s),
                        sdetwei=(None if sdetwei_macro is None
                                 else sdetwei_macro / (2.0 ** s))))
    return out


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

"""Batched element matrices on the host (copy of the JAX package's
``ops/local_matrices.py``).

Shapes: detwei (..., ngi), nx (..., ngi, ndim, nloc), n (ngi, nloc).
"""

from __future__ import annotations

import numpy as np


def mass(n, detwei):
    """M[i,j] = sum_g n[g,i] n[g,j] detwei[g]  -> (..., nloc, nloc)."""
    return np.einsum("gi,gj,...g->...ij", n, n, detwei)


def lumped_mass(n, detwei):
    """ml[j] = sum_g n[g,j] detwei[g] (row-sum lumping) -> (..., nloc)."""
    return np.einsum("gj,...g->...j", n, detwei)


def advection_stiffness(n, nx, detwei, ugi):
    """K[i,j] = sum_{g,d} nx[g,d,i] u[g,d] n[g,j] detwei[g]; the operator
    contributes -K.  ugi: (..., ngi, ndim) velocity at quadrature points."""
    return np.einsum("...gdi,...gd,gj,...g->...ij", nx, ugi, n, detwei)


def diffusion_volume(nx, detwei, k):
    """D[i,j] = k * sum_{g,d} nx[g,d,i] nx[g,d,j] detwei[g] (k scalar or
    batched (...,))."""
    D = np.einsum("...gdi,...gdj,...g->...ij", nx, nx, detwei)
    return D * np.asarray(k)[..., None, None] if np.ndim(k) else k * D


def face_penalty(face_sn, sdetwei, k_over_dx):
    """Interior-penalty surface diffusion coefficient blocks
    P[f, i, j] = (k/dx_f) sum_sg face_sn[f,sg,i] face_sn[f,sg,j]
    sdetwei[f,sg].

    Args:
      face_sn:   (nface, sngi, nloc)
      sdetwei:   (..., nface, sngi)
      k_over_dx: (..., nface)
    Returns (..., nface, nloc, nloc).
    """
    P = np.einsum("fgi,fgj,...fg->...fij", face_sn, face_sn, sdetwei)
    return P * k_over_dx[..., None, None]


def upwind_face_flux(face_sn, face_sn2, sdetwei, snorm, usgi, usgi2,
                     t_sgi, t2_sgi):
    """Upwind DG advection flux of each element, summed over its faces:
    income = 0.5 + 0.5 sign(-snorm . (u + u2) / 2), s_cont_d = snorm_d
    sdetwei ((1 - income) u_d t + income u2_d t2), flux[i] = sum_{f,sg,d}
    face_sn[f,sg,i] s_cont_d.

    Args:
      face_sn: (nface, sngi, nloc); face_sn2 unused (t2_sgi is already the
               neighbor's trace), kept for the JAX package's signature
      sdetwei: (..., nface, sngi)
      snorm, usgi, usgi2: (..., nface, sngi, ndim) the outward normals, my
               and the neighbor's velocity at the surface points
      t_sgi, t2_sgi: (..., nface, sngi) my and the neighbor's trace
    Returns (..., nloc).
    """
    uavg = 0.5 * (usgi + usgi2)
    income = 0.5 + 0.5 * np.sign(-np.sum(snorm * uavg, axis=-1))
    s_cont = snorm * sdetwei[..., None] * (
        ((1.0 - income) * t_sgi)[..., None] * usgi
        + (income * t2_sgi)[..., None] * usgi2)
    return np.einsum("fgi,...fgd->...i", face_sn, s_cont)

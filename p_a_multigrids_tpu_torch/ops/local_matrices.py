"""Batched element matrices on the host (copy of the JAX package's
``ops/local_matrices.py`` functions the slice uses).

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

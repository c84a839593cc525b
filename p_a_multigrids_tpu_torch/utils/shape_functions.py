"""P1 triangle, edge and bilinear quad shape-function tables (host-side
numpy).

Copy of the JAX package's ``utils/shape_functions.py`` for the triangle
element and the quad of mode 1.  Face f of a triangle is the edge ``TRI_FACE_NODES[f] = (a, b)``:
face0 = (0, 2), face1 = (2, 1), face2 = (1, 0), 0-based volume nodes.
"""

from __future__ import annotations

import numpy as np

from . import quadrature

_F = np.float64

# face f -> (volume node of surface node 1, volume node of surface node 2)
TRI_FACE_NODES = np.asarray([[0, 2], [2, 1], [1, 0]], np.int32)


def tri_p1(ngi: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """P1 triangle: returns (n (ngi, 3), nlx (ngi, 2, 3), weight (ngi,))."""
    L, w = quadrature.triangle_rule(ngi)
    n = L.copy()
    nlx = np.zeros((ngi, 2, 3), _F)
    nlx[:, 0, :] = [1.0, 0.0, -1.0]
    nlx[:, 1, :] = [0.0, 1.0, -1.0]
    return n, nlx, w


def edge_p1(sngi: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """P1 line element on [-1,1]: (sn (sngi, 2), snlx (sngi, 1, 2), w)."""
    x, w = quadrature.edge_rule(sngi)
    sn = np.stack([0.5 * (1.0 - x), 0.5 * (1.0 + x)], axis=1)
    snlx = np.zeros((sngi, 1, 2), _F)
    snlx[:, 0, 0] = -0.5
    snlx[:, 0, 1] = 0.5
    return sn, snlx, w


def tri_face_tables(ngi: int = 3, sngi: int = 2):
    """Surface shape-fn tables lifted to volume-node indexing.

    Returns a dict with face_sn / face_sn2 (nface=3, sngi, nloc=3), the
    edge weights ``sweight`` (sngi,) and the edge functions ``sn_orig``.
    """
    sn, _snlx, sw = edge_p1(sngi)
    nface, nloc = 3, 3
    face_sn = np.zeros((nface, sngi, nloc), _F)
    face_sn2 = np.zeros((nface, sngi, nloc), _F)
    for f in range(nface):
        a, b = TRI_FACE_NODES[f]
        face_sn[f, :, a] = sn[:, 0]
        face_sn[f, :, b] = sn[:, 1]
        face_sn2[f, :, a] = sn[:, 0]
        face_sn2[f, :, b] = sn[:, 1]
    return {"face_sn": face_sn, "face_sn2": face_sn2, "sweight": sw,
            "sn_orig": sn}


def quad_bilinear(ngi_1d: int = 2):
    """Bilinear quad by tensor-product Gauss, local nodes at (0,0), (1,0),
    (0,1), (1,1) of the unit square.

    Returns (n (ngi, 4), nlx (ngi, 2, 4), weight (ngi,), face_tables) with
    face_tables: face_sn / face_sn2 (4, sngi, 4), sweight and face_nodes
    (faces 0=bottom, 1=right, 2=top, 3=left, endpoints counter-clockwise).
    """
    x, w = quadrature.gauss_01(ngi_1d)
    ngi = ngi_1d * ngi_1d

    def n1(x):                                          # 1-D P1 on [0,1]
        return np.stack([1.0 - x, x], axis=-1)

    def d1(x):
        return np.stack([-np.ones_like(x), np.ones_like(x)], axis=-1)

    gx, gy = np.meshgrid(x, x, indexing="ij")
    gx, gy = gx.ravel(), gy.ravel()
    wx, wy = np.meshgrid(w, w, indexing="ij")
    weight = (wx * wy).ravel()
    nx_, ny_, dx_, dy_ = n1(gx), n1(gy), d1(gx), d1(gy)
    order = [(0, 0), (1, 0), (0, 1), (1, 1)]
    n = np.zeros((ngi, 4), _F)
    nlx = np.zeros((ngi, 2, 4), _F)
    for k, (i, j) in enumerate(order):
        n[:, k] = nx_[:, i] * ny_[:, j]
        nlx[:, 0, k] = dx_[:, i] * ny_[:, j]
        nlx[:, 1, k] = nx_[:, i] * dy_[:, j]

    face_nodes = np.asarray([[0, 1], [1, 3], [3, 2], [2, 0]], np.int32)
    sx, sw = quadrature.gauss_01(ngi_1d)
    sn1 = n1(sx)                                        # (sngi, 2)
    face_sn = np.zeros((4, ngi_1d, 4), _F)
    for f in range(4):
        a, b = face_nodes[f]
        face_sn[f, :, a] = sn1[:, 0]
        face_sn[f, :, b] = sn1[:, 1]
    ft = {"face_sn": face_sn, "face_sn2": face_sn.copy(),
          "sweight": 2.0 * sw, "face_nodes": face_nodes}
    return n, nlx, weight, ft

"""P1 triangle and edge shape-function tables (host-side numpy).

Copy of the JAX package's ``utils/shape_functions.py`` for the triangle
element.  Face f of a triangle is the edge ``TRI_FACE_NODES[f] = (a, b)``:
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

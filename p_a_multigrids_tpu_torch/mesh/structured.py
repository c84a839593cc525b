"""Generated structured triangular meshes (no files needed); copy of
``tri_mesh`` from the JAX package's ``mesh/structured.py``."""

from __future__ import annotations

import numpy as np

from .topology import MacroMesh, build_macro_mesh


def tri_mesh(no_ele_row: int, no_ele_col: int, dx: float, dy: float
             ) -> MacroMesh:
    """Structured triangular mesh: each dx*dy cell split into two triangles,
    a lower-left "up" one and an upper-right "down" one."""
    nvx, nvy = no_ele_row + 1, no_ele_col + 1
    vx, vy = np.meshgrid(np.arange(nvx) * dx, np.arange(nvy) * dy,
                         indexing="xy")
    vertices = np.stack([vx.ravel(), vy.ravel(),
                         np.zeros(nvx * nvy)], axis=1)

    def vid(i, j):
        return j * nvx + i

    tris = []
    for j in range(no_ele_col):
        for i in range(no_ele_row):
            # "up" triangle: nodes 1=(i+1,j), 2=(i,j+1), 3=(i,j)
            tris.append([vid(i + 1, j), vid(i, j + 1), vid(i, j)])
            # "down" triangle: nodes 1=(i,j+1), 2=(i+1,j), 3=(i+1,j+1)
            tris.append([vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)])
    triangles = np.asarray(tris, np.int32)
    return build_macro_mesh(vertices, triangles)

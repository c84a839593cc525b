"""Plain-text curve outputs of mode 1 (copy of the JAX package's
``io/curves.py``): one row per DG node, x [y] value."""

from __future__ import annotations

import numpy as np


def write_curve(path: str, coords: np.ndarray, values: np.ndarray,
                two_d: bool = True) -> None:
    """Write one row per DG node: x [y] value.

    coords: (E, 2, nloc); values: (E, nloc).
    """
    E, _, nloc = coords.shape
    with open(path, "w") as f:
        for e in range(E):
            for l in range(nloc):
                if two_d:
                    f.write(f"{coords[e, 0, l]} {coords[e, 1, l]} "
                            f"{values[e, l]}\n")
                else:
                    f.write(f"{coords[e, 0, l]} {values[e, l]}\n")

"""VTU / legacy-VTK writers for DG fields (copy of the JAX package's
``io/vtu.py``: the same arrays give byte-identical files,
tests/test_torch_io.py).

Equivalent of the reference's get_vtk_files.F90: ``get_vtu`` writes an XML
.vtu with Tracer / error / analytical point data and per-element
(discontinuous) connectivity; ``get_vtk`` the legacy ASCII format.  Each DG
element contributes its own copies of the nodes so discontinuities are
visible, exactly like the reference.  numpy on the host: a state on the
card is copied over once for each file.
"""

from __future__ import annotations

import numpy as np

_VTK_TRIANGLE = 5
_VTK_QUAD = 9


def write_vtu(path: str, coords: np.ndarray, fields: dict[str, np.ndarray],
              cell_type: int = _VTK_TRIANGLE) -> None:
    """Write an XML VTU file.

    Args:
      coords: (E, 2, nloc) element node coordinates
      fields: name -> (E, nloc) nodal values (e.g. Tracer, error, analytical)
      cell_type: VTK cell type id (5=triangle, 9=quad)
    """
    E, _, nloc = coords.shape
    npoints = E * nloc
    for name, vals in fields.items():
        if np.asarray(vals).size != npoints:
            raise ValueError(
                f"field {name!r} has {np.asarray(vals).size} values for "
                f"{npoints} points")
    pts = np.zeros((npoints, 3))
    pts[:, 0] = coords[:, 0, :].ravel()
    pts[:, 1] = coords[:, 1, :].ravel()
    # VTK quads need the (0,1,3,2) corner order relative to our tensor order
    perm = np.asarray([0, 1, 3, 2]) if cell_type == _VTK_QUAD else (
        np.arange(nloc))
    conn = (np.arange(E)[:, None] * nloc + perm[None, :]).ravel()
    offsets = np.arange(1, E + 1) * nloc

    def arr(a, fmt="%.7g"):
        return " ".join(fmt % v for v in np.asarray(a).ravel())

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{npoints}" '
                f'NumberOfCells="{E}">\n')
        f.write("      <PointData>\n")
        for name, vals in fields.items():
            f.write(f'        <DataArray type="Float32" Name="{name}" '
                    'Format="ascii">\n')
            f.write("          " + arr(vals) + "\n")
            f.write("        </DataArray>\n")
        f.write("      </PointData>\n")
        f.write("      <Points>\n")
        f.write('        <DataArray type="Float32" '
                'NumberOfComponents="3" Format="ascii">\n')
        f.write("          " + arr(pts) + "\n")
        f.write("        </DataArray>\n")
        f.write("      </Points>\n")
        f.write("      <Cells>\n")
        f.write('        <DataArray type="Int32" Name="connectivity" '
                'Format="ascii">\n')
        f.write("          " + arr(conn, "%d") + "\n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="Int32" Name="offsets" '
                'Format="ascii">\n')
        f.write("          " + arr(offsets, "%d") + "\n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="UInt8" Name="types" '
                'Format="ascii">\n')
        f.write("          " + arr(np.full(E, cell_type), "%d") + "\n")
        f.write("        </DataArray>\n")
        f.write("      </Cells>\n")
        f.write("    </Piece>\n")
        f.write("  </UnstructuredGrid>\n")
        f.write("</VTKFile>\n")


def write_vtk_legacy(path: str, coords: np.ndarray, name: str,
                     values: np.ndarray,
                     cell_type: int = _VTK_TRIANGLE) -> None:
    """Legacy ASCII .vtk writer (get_vtk, get_vtk_files.F90:168-239)."""
    E, _, nloc = coords.shape
    npoints = E * nloc
    perm = np.asarray([0, 1, 3, 2]) if cell_type == _VTK_QUAD else (
        np.arange(nloc))
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("p_a_multigrids_tpu output\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {npoints} float\n")
        for e in range(E):
            for l in range(nloc):
                f.write(f"{coords[e, 0, l]:.7g} {coords[e, 1, l]:.7g} 0\n")
        f.write(f"\nCELLS {E} {E * (nloc + 1)}\n")
        for e in range(E):
            ids = " ".join(str(e * nloc + p) for p in perm)
            f.write(f"{nloc} {ids}\n")
        f.write(f"\nCELL_TYPES {E}\n")
        for _ in range(E):
            f.write(f"{cell_type}\n")
        f.write(f"\nPOINT_DATA {npoints}\n")
        f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
        for v in np.asarray(values).ravel():
            f.write(f"{v:.7g}\n")


def semi_coords(mesh_X: np.ndarray, n_split: int) -> np.ndarray:
    """Flattened child coordinates (E_total, 2, 3) for VTU output of the
    semi-structured hierarchy (x_all_str, transport_tri_semi.F90:269-275)."""
    from ..mesh import splitting
    c = splitting.child_coords(mesh_X, n_split)          # (U, C, 2, 3)
    U, C = c.shape[:2]
    return c.reshape(U * C, 2, 3)

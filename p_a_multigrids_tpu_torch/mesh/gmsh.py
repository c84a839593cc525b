"""gmsh 2.x ASCII reader (port of the JAX package's ``mesh/gmsh.py``):
the C++ loader (``utils.native.read_msh``) first, the Python parser
``_read_msh_py`` where the stricter C++ scanner rejects a file.

Both parse ``$Nodes`` / ``$Elements``, keep the triangle element types
{2, 9, 20, 21, 23, 24, 25} (corner vertices only) and record the first tag
as ``region_id``.  The neighbor search lives in ``mesh.topology``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import native

# gmsh element types whose first three nodes are triangle corners
_TRI_TYPES = {2, 9, 20, 21, 23, 24, 25}


@dataclasses.dataclass
class RawGmsh:
    vertices: np.ndarray        # (nnodes, 3) float64
    triangles: np.ndarray       # (E, 3) int32, 0-based vertex ids
    region_id: np.ndarray       # (E,) int32


def read_msh(path: str) -> RawGmsh:
    """Parse a gmsh 2.x ASCII file with the C++ loader.  The Python parser
    defines which files load: a file the C++ scanner rejects (for example
    trailing whitespace on a section tag) is parsed by ``_read_msh_py``,
    and a file both reject raises the Python parser's ValueError.  A failed
    build of the loader raises."""
    try:
        v, t, r = native.read_msh(path)
    except ValueError:
        return _read_msh_py(path)
    return RawGmsh(vertices=v, triangles=t, region_id=r)


def _read_msh_py(path: str) -> RawGmsh:
    """The plain Python parser (the JAX package's ``_read_msh_py``)."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0

    def seek(tag: str) -> int:
        nonlocal i
        while i < len(lines) and lines[i].strip() != tag:
            i += 1
        if i == len(lines):
            raise ValueError(f"{path}: section {tag} not found")
        i += 1
        return i

    seek("$MeshFormat")
    parts = lines[i].split()
    version = float(parts[0])
    if not (2.0 <= version <= 2.2):
        raise ValueError(f"{path}: unsupported gmsh version {version}; "
                         "only 2.x ASCII is supported")
    if int(parts[1]) != 0:
        raise ValueError(f"{path}: binary .msh not supported")

    seek("$Nodes")
    nnodes = int(lines[i])
    i += 1
    vertices = np.zeros((nnodes, 3), np.float64)
    for k in range(nnodes):
        parts = lines[i + k].split()
        idx = int(parts[0]) - 1
        vertices[idx] = [float(parts[1]), float(parts[2]), float(parts[3])]
    i += nnodes

    seek("$Elements")
    nelems = int(lines[i])
    i += 1
    tris = []
    regions = []
    for k in range(nelems):
        parts = lines[i + k].split()
        etype = int(parts[1])
        if etype not in _TRI_TYPES:
            continue
        ntags = int(parts[2])
        regions.append(int(parts[3]) if ntags >= 1 else 0)
        base = 3 + ntags
        tris.append([int(parts[base]), int(parts[base + 1]),
                     int(parts[base + 2])])
    triangles = np.asarray(tris, np.int32).reshape(-1, 3) - 1
    # node id 0 would otherwise wrap to the last vertex as index -1
    if len(triangles) and (triangles.min() < 0
                           or triangles.max() >= nnodes):
        raise ValueError(f"{path}: triangle node id out of range "
                         f"1..{nnodes}")
    region_id = np.asarray(regions, np.int32)
    return RawGmsh(vertices=vertices, triangles=triangles, region_id=region_id)


def write_msh(path: str, mesh) -> None:
    """Write a ``topology.MacroMesh`` as a gmsh 2.2 ASCII file of type-2
    triangles (tags: region id, then elementary id 1).  Coordinates are
    written with 17 significant digits, so ``read_msh`` gives them back
    exactly.

    A fixture writer with no counterpart in the JAX package: no solver path
    calls it.  The tests and ``chip_smoke.py`` use it to make ``.msh``
    files from generated meshes."""
    nv = int(mesh.tri.max()) + 1
    verts = np.zeros((nv, 2))
    verts[mesh.tri.reshape(-1)] = mesh.X.transpose(0, 2, 1).reshape(-1, 2)
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(nv)]
    lines += [f"{k + 1} {x:.17g} {y:.17g} 0" for k, (x, y) in
              enumerate(verts)]
    lines += ["$EndNodes", "$Elements", str(len(mesh.tri))]
    lines += [f"{e + 1} 2 2 {int(r)} 1 {a + 1} {b + 1} {c + 1}" for e, (
        (a, b, c), r) in enumerate(zip(mesh.tri, mesh.region_id))]
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))

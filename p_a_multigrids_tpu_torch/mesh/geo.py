"""Gmsh ``.geo`` geometry reader and macro-mesh generator (copy of the JAX
package's ``mesh/geo.py`` on this package's ``expressions`` and
``topology``; tests/test_torch_expressions_geo.py holds the meshes it makes
equal to the original's, field by field).

Counterpart of the reference's ``Geo2poly.F90`` (``Read_geo``,
``CreatePoly``), which parses a gmsh ``.geo`` file and bridges it to the
aCute mesher via ``.poly`` files.  Here the bridge is internal: a ``.geo``
geometry is parsed into points / lines / line loops / plane surfaces and
triangulated directly into a :class:`~p_a_multigrids_tpu_torch.mesh.topology.MacroMesh`
(macro-elements ready for semi-structured splitting), so no external mesher
is needed for polygonal domains.

Supported .geo subset (the constructs Read_geo handles):

- ``lc = 0.1;`` and other scalar parameter assignments (usable in
  coordinates via the expression evaluator)
- ``Point(id) = {x, y, z, lc};``
- ``Line(id) = {p1, p2};``
- ``Circle(id) = {start, center, end};`` (arc, sampled into segments)
- ``Line Loop(id) = {l1, l2, ...};`` / ``Curve Loop``
- ``Plane Surface(id) = {loop1, loop2, ...};`` (first loop = outer
  boundary, the rest are holes)
- ``Physical Surface(id) = {...};`` -> region_id of the contained elements

Triangulation: boundary polygons are resampled to the target edge length
``lc``, interior seed points are laid on a hexagonal lattice, and a
Delaunay triangulation (scipy's) is filtered to the polygon (holes
removed).  The result is an unstructured macro mesh in the same form as the
gmsh ``.msh`` reader's output.  The Delaunay step is scipy's Qhull: two
installations may triangulate the same points differently, so compare the
meshes of two machines by their X (``validation.history.mesh_hash``).
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..utils.expressions import Expression
from . import topology

__all__ = ["GeoGeometry", "read_geo", "mesh_geo"]

_STMT = re.compile(
    r"(?P<kind>Point|Line Loop|Curve Loop|Plane Surface|Physical Surface"
    r"|Line|Circle)\s*\(\s*(?P<id>\w+)\s*\)\s*=\s*\{(?P<args>[^}]*)\}",
    re.IGNORECASE)
_ASSIGN = re.compile(r"^\s*([A-Za-z_]\w*)\s*=\s*([^;]+);", re.MULTILINE)


class GeoGeometry:
    """Parsed .geo contents (ids as in the file)."""

    def __init__(self):
        self.params: dict[str, float] = {}
        self.points: dict[int, np.ndarray] = {}   # id -> (x, y)
        self.point_lc: dict[int, float] = {}
        self.lines: dict[int, list[int]] = {}     # id -> point ids (polyline)
        self.loops: dict[int, list[int]] = {}     # id -> signed line ids
        self.surfaces: dict[int, list[int]] = {}  # id -> loop ids
        self.physical: dict[int, list[int]] = {}  # phys id -> surface ids

    def loop_polygon(self, loop_id: int) -> np.ndarray:
        """Ordered (n, 2) vertex chain of a line loop (not closed)."""
        chain: list[np.ndarray] = []
        for signed in self.loops[loop_id]:
            pts = self.lines[abs(signed)]
            if signed < 0:
                pts = pts[::-1]
            seg = [self.points[p] for p in pts]
            if chain and np.allclose(chain[-1], seg[0]):
                seg = seg[1:]
            chain.extend(seg)
        if len(chain) > 1 and np.allclose(chain[0], chain[-1]):
            chain = chain[:-1]
        return np.asarray(chain, float)


def _strip_comments(text: str) -> str:
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"/\*.*?\*/", "", text, flags=re.DOTALL)


def _num(token: str, params: dict[str, float]) -> float:
    token = token.strip()
    try:
        return float(token)
    except ValueError:
        return float(Expression(token, variables=(), parameters=params)())


def read_geo(path_or_text: str) -> GeoGeometry:
    """Parse a .geo file (path or literal text) -> GeoGeometry."""
    if "\n" in path_or_text or "=" in path_or_text:
        text = path_or_text
        if not _STMT.search(path_or_text) and "\n" not in path_or_text:
            with open(path_or_text) as f:
                text = f.read()
    else:
        with open(path_or_text) as f:
            text = f.read()
    text = _strip_comments(text)
    geo = GeoGeometry()

    # scalar assignments first (lc = 0.05; h = lc/2; ...)
    for name, value in _ASSIGN.findall(text):
        if name.lower() in ("point", "line", "circle"):
            continue
        try:
            geo.params[name] = _num(value, geo.params)
        except Exception:
            pass

    for m in _STMT.finditer(text):
        kind = m.group("kind").lower()
        ident = int(_num(m.group("id"), geo.params))
        args = [a for a in m.group("args").split(",") if a.strip()]
        vals = [_num(a, geo.params) for a in args]
        if kind == "point":
            geo.points[ident] = np.asarray(vals[:2], float)
            geo.point_lc[ident] = vals[3] if len(vals) > 3 else 0.0
        elif kind == "line":
            geo.lines[ident] = [int(v) for v in vals]
        elif kind == "circle":
            start, center, end = (int(v) for v in vals[:3])
            geo.lines[ident] = _sample_arc(geo, ident, start, center, end)
        elif kind in ("line loop", "curve loop"):
            geo.loops[ident] = [int(v) for v in vals]
        elif kind == "plane surface":
            geo.surfaces[ident] = [int(v) for v in vals]
        elif kind == "physical surface":
            geo.physical[ident] = [int(v) for v in vals]
    return geo


def _sample_arc(geo: GeoGeometry, ident: int, start: int, center: int,
                end: int, segments: int = 16) -> list[int]:
    """Sample a circular arc into a polyline, registering new points."""
    c = geo.points[center]
    a = geo.points[start] - c
    b = geo.points[end] - c
    r = np.linalg.norm(a)
    th0 = math.atan2(a[1], a[0])
    th1 = math.atan2(b[1], b[0])
    # gmsh Circle arcs are < pi and traverse counterclockwise start -> end
    dth = (th1 - th0) % (2 * math.pi)
    if dth > math.pi:
        dth -= 2 * math.pi
    ids = [start]
    base = max(list(geo.points) + [0]) + 1000 * ident
    for i in range(1, segments):
        th = th0 + dth * i / segments
        pid = base + i
        geo.points[pid] = c + r * np.asarray([math.cos(th), math.sin(th)])
        ids.append(pid)
    ids.append(end)
    return ids


def _resample_polygon(poly: np.ndarray, h: float) -> np.ndarray:
    """Insert points so no boundary edge is longer than ~h."""
    out = []
    n = len(poly)
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        L = np.linalg.norm(b - a)
        k = max(1, int(math.ceil(L / h)))
        for j in range(k):
            out.append(a + (b - a) * (j / k))
    return np.asarray(out)


def _point_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Vectorized even-odd rule: pts (n, 2), poly (m, 2) -> (n,) bool."""
    x, y = pts[:, 0, None], pts[:, 1, None]
    x0, y0 = poly[:, 0][None], poly[:, 1][None]
    x1 = np.roll(poly[:, 0], -1)[None]
    y1 = np.roll(poly[:, 1], -1)[None]
    cond = (y0 <= y) != (y1 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xin = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
    crossing = cond & (x < xin)
    return crossing.sum(axis=1) % 2 == 1


def _hex_lattice(bbox, h: float) -> np.ndarray:
    (xmin, ymin), (xmax, ymax) = bbox
    dy = h * math.sqrt(3) / 2
    rows = []
    j = 0
    y = ymin + dy
    while y < ymax - 0.25 * dy:
        xs = np.arange(xmin + (0.5 * h if j % 2 else h), xmax - 0.25 * h, h)
        rows.append(np.stack([xs, np.full_like(xs, y)], axis=1))
        y += dy
        j += 1
    return (np.concatenate(rows, axis=0) if rows
            else np.zeros((0, 2)))


def mesh_geo(path_or_text: str, h: float | None = None) -> topology.MacroMesh:
    """Triangulate the (first) plane surface of a .geo file.

    ``h`` overrides the characteristic length; default is the smallest
    nonzero point lc, else 1/8 of the bounding-box diagonal.
    """
    from scipy.spatial import Delaunay

    geo = read_geo(path_or_text)
    if not geo.surfaces:
        raise ValueError("no Plane Surface in .geo input")
    surf_id, loop_ids = next(iter(geo.surfaces.items()))
    outer = geo.loop_polygon(loop_ids[0])
    holes = [geo.loop_polygon(l) for l in loop_ids[1:]]

    if h is None:
        lcs = [v for v in geo.point_lc.values() if v > 0]
        diag = np.linalg.norm(outer.max(0) - outer.min(0))
        h = min(lcs) if lcs else diag / 8.0

    pts = [_resample_polygon(outer, h)]
    for hole in holes:
        pts.append(_resample_polygon(hole, h))
    boundary_pts = np.concatenate(pts, axis=0)

    seeds = _hex_lattice((outer.min(0), outer.max(0)), h)
    if len(seeds):
        keep = _point_in_polygon(seeds, outer)
        for hole in holes:
            keep &= ~_point_in_polygon(seeds, hole)
        # drop seeds hugging the boundary (bad-quality slivers)
        d = np.linalg.norm(
            seeds[:, None, :] - boundary_pts[None, :, :], axis=-1).min(1)
        keep &= d > 0.5 * h
        seeds = seeds[keep]
    vertices = np.concatenate([boundary_pts, seeds], axis=0)

    tri = Delaunay(vertices)
    simplices = tri.simplices
    cent = vertices[simplices].mean(axis=1)
    keep = _point_in_polygon(cent, outer)
    for hole in holes:
        keep &= ~_point_in_polygon(cent, hole)
    simplices = simplices[keep]

    # drop now-unused vertices, renumber
    used = np.unique(simplices)
    remap = -np.ones(len(vertices), np.int64)
    remap[used] = np.arange(len(used))
    simplices = remap[simplices]
    vertices = vertices[used]

    region = np.full(len(simplices), surf_id, np.int32)
    for phys, surfs in geo.physical.items():
        if surf_id in surfs:
            region[:] = phys
    return topology.build_macro_mesh(vertices, simplices, region_id=region)

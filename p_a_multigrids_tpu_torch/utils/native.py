"""ctypes bridge to the host C++ mesh loaders (``csrc/mesh_accel.cpp``,
``csrc/gmsh_reader.cpp``): the macro mesh's neighbor topology and the gmsh
2.x ASCII reader, with the contracts of the JAX package's
``utils/native.py``.

Each library is built with the C++ compiler at first use
(``cuda_build.load_host``, into ``_build/``).  There is no fallback: a
missing compiler or a failed build raises.  The plain Python versions
(``mesh.topology._neighbor_topology_py``, ``mesh.gmsh._read_msh_py``) stay
beside them as the references the tests hold them to.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import cuda_build

_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """The built and loaded library ``csrc/<name>.cpp`` with its C
    signatures declared."""
    lib, _ = cuda_build.load_host(name)
    if name == "mesh_accel":
        lib.neighbor_topology.restype = ctypes.c_int
        lib.neighbor_topology.argtypes = [
            _I32P, ctypes.c_int64, _I32P, _I32P,
            ctypes.POINTER(ctypes.c_uint8)]
    else:
        lib.gmsh_read.restype = ctypes.c_int
        lib.gmsh_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_F64P),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(_I32P),
            ctypes.POINTER(_I32P), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64]
        lib.gmsh_free.restype = None
        lib.gmsh_free.argtypes = [_F64P, _I32P, _I32P]
    return lib


def available() -> bool:
    """True once both libraries are built and loaded; a failed build
    raises."""
    for name in ("mesh_accel", "gmsh_reader"):
        _lib(name)
    return True


def neighbor_topology(triangles: np.ndarray):
    """C++ edge-hash neighbor search: (neig, neigh_face, dir_flag), the
    contract of ``mesh.topology._neighbor_topology_py``."""
    U = triangles.shape[0]
    tri = np.ascontiguousarray(triangles, np.int32)
    neig = np.full((U, 3), -1, np.int32)
    nface = np.full((U, 3), -1, np.int32)
    dirf = np.zeros((U, 3), np.uint8)
    rc = _lib("mesh_accel").neighbor_topology(
        tri.ctypes.data_as(_I32P), ctypes.c_int64(U),
        neig.ctypes.data_as(_I32P), nface.ctypes.data_as(_I32P),
        dirf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"mesh_accel.neighbor_topology failed rc={rc}")
    return neig, nface, dirf.astype(bool)


def read_msh(path: str):
    """C++ gmsh 2.x loader, the contract of ``mesh.gmsh._read_msh_py``:
    (vertices (N, 3) f64, triangles (E, 3) i32 0-based, region_id (E,)
    i32); raises ValueError("<path>: <message>") on malformed input."""
    lib = _lib("gmsh_reader")
    verts_p, tris_p, regs_p = _F64P(), _I32P(), _I32P()
    nnodes, ntris = ctypes.c_int64(0), ctypes.c_int64(0)
    errbuf = ctypes.create_string_buffer(256)
    rc = lib.gmsh_read(str(path).encode(), ctypes.byref(verts_p),
                       ctypes.byref(nnodes), ctypes.byref(tris_p),
                       ctypes.byref(regs_p), ctypes.byref(ntris),
                       errbuf, ctypes.c_int64(len(errbuf)))
    if rc != 0:
        raise ValueError(f"{path}: {errbuf.value.decode()}")
    try:
        n, e = nnodes.value, ntris.value
        vertices = (np.ctypeslib.as_array(verts_p, (n, 3)).copy()
                    if n else np.zeros((0, 3), np.float64))
        triangles = (np.ctypeslib.as_array(tris_p, (e, 3)).copy()
                     if e else np.zeros((0, 3), np.int32))
        region_id = (np.ctypeslib.as_array(regs_p, (e,)).copy()
                     if e else np.zeros((0,), np.int32))
    finally:
        lib.gmsh_free(verts_p, tris_p, regs_p)
    return vertices, triangles, region_id

"""The port's C++ mesh loaders (utils/native.py, csrc/mesh_accel.cpp,
csrc/gmsh_reader.cpp) == the port's Python paths == the JAX package's
native and Python paths, bit for bit; the reader falls back only where the
C++ scanner rejects a file; a failed build raises; builds that start
together make one library."""

import torch_threads  # noqa: F401

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from p_a_multigrids_tpu.mesh import gmsh as jgmsh
from p_a_multigrids_tpu.mesh import topology as jtopo
from p_a_multigrids_tpu.utils import native as jnative

from p_a_multigrids_tpu_torch.mesh import gmsh, structured, topology
from p_a_multigrids_tpu_torch.utils import cuda_build, native
from p_a_multigrids_tpu_torch.utils.profiling import painted_mesh

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"tri_16x12": lambda: structured.tri_mesh(16, 12, 1 / 16, 1 / 12),
          "painted_64": lambda: painted_mesh(64)}


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library (built by its own make at first
    use; another test process may be building it at the same moment)."""
    for _ in range(60):
        if jnative.available():
            return jnative
        jnative._TRIED = False
        time.sleep(1)
    pytest.fail("the JAX package's native library did not build")


@pytest.fixture(params=list(MESHES))
def mesh(request):
    return MESHES[request.param]()


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_available():
    assert native.available()


def test_neighbor_topology_matches_every_path(mesh, jax_native):
    got = native.neighbor_topology(mesh.tri)
    for name, want in (
            ("port python", topology._neighbor_topology_py(mesh.tri)),
            ("jax native", jax_native.neighbor_topology(mesh.tri)),
            ("jax python", jtopo._neighbor_topology_py(mesh.tri))):
        for g, w, key in zip(got, want, ("neig", "neigh_face", "dir_flag")):
            _equal(g, w, f"{name} {key}")
    # build_macro_mesh runs the C++ search
    for key, g in zip(("neig", "neigh_face", "dir_flag"), got):
        _equal(getattr(mesh, key), g, key)


def test_read_msh_matches_every_path(mesh, jax_native, tmp_path):
    path = str(tmp_path / "m.msh")
    gmsh.write_msh(path, mesh)
    v, t, r = native.read_msh(path)
    jv, jt, jr = jax_native.read_msh(path)
    for raw, name in ((gmsh.read_msh(path), "port read_msh"),
                      (gmsh._read_msh_py(path), "port python"),
                      (jgmsh._read_msh_py(path), "jax python")):
        _equal(v, raw.vertices, f"{name} vertices")
        _equal(t, raw.triangles, f"{name} triangles")
        _equal(r, raw.region_id, f"{name} region_id")
    for a, b, key in ((v, jv, "vertices"), (t, jt, "triangles"),
                      (r, jr, "region_id")):
        _equal(a, b, f"jax native {key}")
    # and the macro mesh built from the file
    got, want = topology.from_msh(path), jtopo.from_msh(path)
    for key in ("X", "tri", "neig", "neigh_face", "dir_flag", "region_id"):
        _equal(getattr(got, key), getattr(want, key), key)


def test_malformed_files_raise_the_jax_messages(tmp_path, jax_native):
    """tests/test_mesh.py's native reader error cases: the same
    ValueError messages as the JAX package's loader."""
    bad = tmp_path / "bad.msh"
    bad.write_text("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
    for path, match in ((bad, "unsupported gmsh version"),
                        (tmp_path / "missing.msh", "cannot open")):
        with pytest.raises(ValueError, match=match) as got:
            native.read_msh(str(path))
        with pytest.raises(ValueError) as want:
            jax_native.read_msh(str(path))
        assert str(got.value) == str(want.value)


def test_trailing_whitespace_tag_loads_through_python(tmp_path):
    """A section tag with trailing whitespace: the C++ scanner rejects the
    file, the Python parser accepts it, so read_msh loads it."""
    path = tmp_path / "ws.msh"
    gmsh.write_msh(str(path), structured.tri_mesh(3, 2, 1 / 3, 1 / 2))
    text = path.read_text().replace("$Nodes\n", "$Nodes  \n")
    path.write_text(text)
    with pytest.raises(ValueError, match="Nodes"):
        native.read_msh(str(path))
    got, want = gmsh.read_msh(str(path)), jgmsh._read_msh_py(str(path))
    for key in ("vertices", "triangles", "region_id"):
        _equal(getattr(got, key), getattr(want, key), key)


def test_file_both_reject_raises_the_python_error(tmp_path):
    bad = tmp_path / "v4.msh"
    bad.write_text("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="unsupported gmsh version 4.1"):
        gmsh.read_msh(str(bad))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: with the compiler replaced by ``false`` the build
    raises, and so do the loaders and the mesh builder over them."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        cuda_build.load_host("mesh_accel")
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="false failed"):
            native.available()
        with pytest.raises(RuntimeError, match="false failed"):
            structured.tri_mesh(2, 2, 0.5, 0.5)
    finally:
        native._lib.cache_clear()
    assert not list(tmp_path.glob("*.so"))


BUILD = """
import json, pathlib, sys
from p_a_multigrids_tpu_torch.utils import cuda_build
cuda_build.BUILD_DIR = pathlib.Path(sys.argv[1])
_, info = cuda_build.load_host("gmsh_reader")
print(json.dumps(info))
"""


def test_builds_that_start_together_make_one_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    infos = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0
        infos.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(i["cached"] for i in infos) == [False, True]
    assert infos[0]["path"] == infos[1]["path"]
    assert [p.name for p in tmp_path.glob("*.so")] == [
        pathlib.Path(infos[0]["path"]).name]
    assert not list(tmp_path.glob(".*.so"))

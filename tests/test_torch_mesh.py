"""gmsh macro meshes in the port (mesh/gmsh.py, topology.from_msh, the
CLI's --mesh) == the JAX package's, on .msh files written from generated
meshes."""

import torch_threads  # noqa: F401

import json

import numpy as np
import pytest

from p_a_multigrids_tpu import __main__ as jcli
from p_a_multigrids_tpu.mesh import gmsh as jgmsh
from p_a_multigrids_tpu.mesh import topology as jtopology

from p_a_multigrids_tpu_torch import __main__ as tcli
from p_a_multigrids_tpu_torch.mesh import gmsh as tgmsh
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.mesh import topology as ttopology


@pytest.fixture
def msh(tmp_path):
    """A 3 x 2 structured mesh with region 4 (painted to 1 by the initial
    condition) on every third macro, written as gmsh 2.2 ASCII."""
    mesh = tstruct.tri_mesh(3, 2, 1 / 3, 1 / 2)
    mesh.region_id = np.where(np.arange(mesh.num_elements) % 3 == 0, 4,
                              1).astype(np.int32)
    path = tmp_path / "macro.msh"
    tgmsh.write_msh(str(path), mesh)
    return str(path), mesh


def test_readers_agree(msh):
    path, _ = msh
    got = tgmsh.read_msh(path)
    for want in (jgmsh._read_msh_py(path), jgmsh.read_msh(path)):
        for name in ("vertices", "triangles", "region_id"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_from_msh_matches_jax_and_round_trips(msh):
    path, mesh = msh
    got = ttopology.from_msh(path)
    want = jtopology.from_msh(path)
    for name in ("X", "tri", "neig", "neigh_face", "dir_flag", "region_id"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
        # 17 significant digits give the coordinates back exactly
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(mesh, name), err_msg=name)


def test_reader_rejects_bad_files(tmp_path):
    bad = tmp_path / "v4.msh"
    bad.write_text("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="version"):
        tgmsh.read_msh(str(bad))
    missing = tmp_path / "no_nodes.msh"
    missing.write_text("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match=r"\$Nodes"):
        tgmsh.read_msh(str(missing))


@pytest.mark.parametrize("extra", [[], ["--krylov", "--dt", "1e8"]],
                         ids=["vcycle", "pcg"])
def test_cli_mesh_matches_jax(msh, extra, capsys):
    """python -m p_a_multigrids_tpu_torch --mesh F.msh --device cpu --f64
    == python -m p_a_multigrids_tpu --mesh F.msh --cpu --f64."""
    path, mesh = msh
    argv = ["--mode", "9", "--mesh", path, "--n-split", "2", "--levels",
            "2", "--ntime", "2"] + extra
    jcli.main(argv + ["--cpu", "--f64"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tcli.main(argv + ["--device", "cpu", "--f64"])
    assert got["elements"] == want["elements"] == mesh.num_elements
    assert got["children"] == want["children"] == 16
    assert got["L1_error"] == pytest.approx(want["L1_error"], rel=1e-9)
    assert got["residual_history"] == pytest.approx(
        want["residual_history"], rel=1e-9)
    assert got["residual"] == pytest.approx(want["residual"], rel=1e-9)
    assert ("krylov_iterations" in got) == bool(extra)

"""The port's VTU writers and checkpoints == the JAX package's: the same
arrays give byte-identical files, the CLI's --vtu / --vtk-interval series
has the JAX CLI's names and count, a checkpointed run resumes bit for bit,
and a checkpoint written by either package resumes in the other (float64,
CPU, 1e-12)."""

import torch_threads  # noqa: F401

import json
import os

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import __main__ as jcli
from p_a_multigrids_tpu.config import SemiConfig as JSemiConfig
from p_a_multigrids_tpu.io import checkpoint as jckpt
from p_a_multigrids_tpu.io import vtu as jvtu

from p_a_multigrids_tpu_torch import __main__ as tcli
from p_a_multigrids_tpu_torch.config import SemiConfig as TSemiConfig
from p_a_multigrids_tpu_torch.io import checkpoint as tckpt
from p_a_multigrids_tpu_torch.io import vtu as tvtu
from p_a_multigrids_tpu_torch.mesh import structured

SMALL = ["--mode", "9", "--rows", "4", "--cols", "4"]


def _fields(rng, E, nloc, dtype):
    vals = rng.normal(size=(E, nloc)).astype(dtype)
    return {"Tracer": vals, "error": np.abs(vals) * 1e-3,
            "analytical": vals[::-1].copy()}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cell_type,nloc", [(5, 3), (9, 4)],
                         ids=["tri", "quad"])
def test_writers_byte_identical(tmp_path, dtype, cell_type, nloc):
    rng = np.random.default_rng(11)
    coords = rng.uniform(-2, 2, size=(13, 2, nloc))
    fields = _fields(rng, 13, nloc, dtype)
    for name, writer in (("t", tvtu), ("j", jvtu)):
        writer.write_vtu(str(tmp_path / f"{name}.vtu"), coords, fields,
                         cell_type=cell_type)
        writer.write_vtk_legacy(str(tmp_path / f"{name}.vtk"), coords,
                                "Tracer", fields["Tracer"],
                                cell_type=cell_type)
    for ext in ("vtu", "vtk"):
        assert ((tmp_path / f"t.{ext}").read_bytes()
                == (tmp_path / f"j.{ext}").read_bytes())
    with pytest.raises(ValueError, match="values for"):
        tvtu.write_vtu(str(tmp_path / "bad.vtu"), coords,
                       {"Tracer": fields["Tracer"][:-1]})


@pytest.mark.parametrize("n_split", [0, 1, 2])
def test_semi_coords_match(n_split):
    X = structured.tri_mesh(3, 2, 1 / 3, 1 / 2).X
    np.testing.assert_array_equal(tvtu.semi_coords(X, n_split),
                                  jvtu.semi_coords(X, n_split))


def _tracer(path):
    """The Tracer array of a VTU file the writers made."""
    lines = open(path).read().splitlines()
    at = next(i for i, ln in enumerate(lines) if 'Name="Tracer"' in ln)
    return np.asarray(lines[at + 1].split(), float)


def test_cli_vtk_series(tmp_path, capsys):
    """tests/test_cli.py's series on a generated mesh: 2 steps, interval 1
    -> files 0000, 0001 and the final 0002, with the JAX CLI's names; each
    file's Tracer is the state of its step."""
    argv = SMALL + ["--n-split", "1", "--levels", "1", "--ntime", "2",
                    "--dt", "100000.0", "--vtk-interval", "1"]
    jcli.main(argv + ["--vtu", str(tmp_path / "j.vtu"), "--cpu", "--f64"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, T, _ = tcli.run(argv + ["--vtu", str(tmp_path / "t.vtu"),
                                 "--device", "cpu", "--f64"])
    assert len(got["vtu_series"]) == len(want["vtu_series"]) == 3
    assert [os.path.basename(p)[1:] for p in got["vtu_series"]] == [
        os.path.basename(p)[1:] for p in want["vtu_series"]]
    for p in got["vtu_series"] + [got["vtu"]]:
        assert os.path.exists(p)
    np.testing.assert_allclose(_tracer(got["vtu_series"][-1]),
                               T.numpy().reshape(-1), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_tracer(got["vtu"]), T.numpy().reshape(-1),
                               rtol=1e-6, atol=1e-7)
    # each file of the series, the JAX CLI's against the port's
    for p, q in zip(got["vtu_series"], want["vtu_series"]):
        np.testing.assert_allclose(_tracer(p), _tracer(q), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("argv", [
    ["--mode", "1", "--rows", "24", "--cols", "1"],
    ["--mode", "3", "--rows", "4", "--cols", "4"],
    ["--mode", "8", "--rows", "4", "--cols", "4"],
    SMALL + ["--n-split", "1", "--ntime", "1"],
], ids=["mode1", "mode3", "mode8", "mode9"])
def test_cli_final_vtu_matches_jax_layout(argv, tmp_path, capsys):
    """--vtu in every kind of mode: the port's file has the JAX CLI's
    points, cells and cell type (the same bytes outside the Tracer
    values), and its Tracer values agree."""
    jcli.main(argv + ["--vtu", str(tmp_path / "j.vtu"), "--cpu", "--f64"])
    tcli.main(argv + ["--vtu", str(tmp_path / "t.vtu"), "--device", "cpu",
                      "--f64"])
    capsys.readouterr()
    tl = (tmp_path / "t.vtu").read_text().splitlines()
    jl = (tmp_path / "j.vtu").read_text().splitlines()
    at = next(i for i, ln in enumerate(jl) if 'Name="Tracer"' in ln) + 1
    assert tl[:at] + tl[at + 1:] == jl[:at] + jl[at + 1:]
    np.testing.assert_allclose(_tracer(tmp_path / "t.vtu"),
                               _tracer(tmp_path / "j.vtu"), rtol=1e-6,
                               atol=1e-7)


def test_checkpoint_format_both_ways(tmp_path):
    """save / load of either package reads the other's file."""
    rng = np.random.default_rng(4)
    T = rng.normal(size=(5, 4, 3)).astype(np.float32)
    tckpt.save(str(tmp_path / "t.npz"), T, step=7, cfg=TSemiConfig(),
               extra={"residual": np.asarray([1.0, 0.5])})
    jckpt.save(str(tmp_path / "j.npz"), T, step=7, cfg=JSemiConfig())
    for path in ("t.npz", "j.npz"):
        for loader in (tckpt.load, jckpt.load):
            T2, step, meta, extras = loader(str(tmp_path / path))
            np.testing.assert_array_equal(T2, T)
            assert step == 7 and meta["cfg"]["n_split"] == 1
    assert set(tckpt.load(str(tmp_path / "t.npz"))[3]) == {"residual"}


CKPT_RUNS = {
    7: SMALL[:0] + ["--mode", "7", "--rows", "4", "--cols", "4",
                    "--dt", "1e-7"],
    9: SMALL + ["--n-split", "2", "--levels", "2"],
    10: ["--mode", "10", "--rows", "4", "--cols", "4", "--dt", "0.05"],
}


@pytest.mark.parametrize("mode", [7, 9, 10])
def test_checkpoint_resume_bit_for_bit(mode, tmp_path):
    """4 steps straight == 2 steps, a checkpoint, and a resume to 4."""
    ck = str(tmp_path / "run.npz")
    argv = CKPT_RUNS[mode] + ["--device", "cpu", "--f64"]
    full, T_full, _ = tcli.run(argv + ["--ntime", "4"])
    first = tcli.run(argv + ["--ntime", "2", "--checkpoint", ck,
                             "--checkpoint-every", "2"])[0]
    assert tckpt.load(ck)[1] == 2
    res, T_res, _ = tcli.run(argv + ["--ntime", "4", "--checkpoint", ck,
                                     "--checkpoint-every", "2"])
    assert "resumed_from_step" not in first
    assert res["resumed_from_step"] == 2
    assert (first["residual_history"] + res["residual_history"]
            == full["residual_history"])
    assert res["L1_error"] == full["L1_error"]
    np.testing.assert_array_equal(T_res.numpy(), T_full.numpy())
    np.testing.assert_array_equal(tckpt.load(ck)[0], T_full.numpy())


@pytest.mark.parametrize("mode", [7, 9, 10])
def test_run_with_checkpoints_resumes(mode, tmp_path):
    """run_with_checkpoints over each solver's stepper: 4 steps straight ==
    2 steps saved and 2 more from the loaded file, bit for bit; a save is
    made at the last step, and observe sees every step's state."""
    solver = tcli.setup(CKPT_RUNS[mode] + ["--device", "cpu", "--f64"])[2]
    T0 = solver.initial_condition()
    seen = []
    full = tckpt.run_with_checkpoints(
        solver, T0, 4, None, observe=lambda k, S, st: seen.append(
            (k, float(st.convergence(S)))))
    assert [k for k, _ in seen] == [0, 1, 2, 3, 4]
    assert seen[-1][1] == float(solver.convergence(full))
    ck = str(tmp_path / "ck.npz")
    tckpt.run_with_checkpoints(solver, T0, 2, ck, every=2)
    T2, step, meta, _ = tckpt.load(ck)
    assert step == 2 and meta["cfg"]["n_split"] == solver.cfg.n_split
    res = tckpt.run_with_checkpoints(solver, torch.as_tensor(T2), 4, ck,
                                     every=3, start_step=2)
    np.testing.assert_array_equal(res.numpy(), full.numpy())
    assert tckpt.load(ck)[1] == 4
    np.testing.assert_array_equal(tckpt.load(ck)[0], full.numpy())


def _final(path):
    return np.load(path)["T"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path, capsys):
    """A checkpoint one CLI writes after 2 steps, resumed to 4 by the other
    CLI, ends where the resuming package's straight 4-step run ends."""
    argv = SMALL + ["--n-split", "2", "--levels", "2"]
    ck, straight = str(tmp_path / "ck.npz"), str(tmp_path / "straight.npz")
    tail = ["--checkpoint-every", "2"]
    if writer == "jax":
        jcli.main(argv + ["--ntime", "2", "--checkpoint", ck, "--cpu",
                          "--f64"] + tail)
        res = tcli.main(argv + ["--ntime", "4", "--checkpoint", ck,
                                "--device", "cpu", "--f64"] + tail)
        full = tcli.main(argv + ["--ntime", "4", "--checkpoint", straight,
                                 "--device", "cpu", "--f64"] + tail)
    else:
        tcli.main(argv + ["--ntime", "2", "--checkpoint", ck, "--device",
                          "cpu", "--f64"] + tail)
        capsys.readouterr()
        jcli.main(argv + ["--ntime", "4", "--checkpoint", ck, "--cpu",
                          "--f64"] + tail)
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        jcli.main(argv + ["--ntime", "4", "--checkpoint", straight, "--cpu",
                          "--f64"] + tail)
        full = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    capsys.readouterr()
    assert res["resumed_from_step"] == 2
    np.testing.assert_allclose(_final(ck), _final(straight), rtol=1e-12,
                               atol=1e-12)
    for key in ("L1_error", "residual"):
        assert res[key] == pytest.approx(full[key], rel=1e-12), key
    np.testing.assert_allclose(res["residual_history"],
                               full["residual_history"][2:], rtol=1e-12)

"""The port's CLI == the JAX package's CLI (float64, CPU) in modes 2-10;
flags and modes the port lacks exit with a message; the port runs with jax
blocked."""

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from p_a_multigrids_tpu import __main__ as jcli

from p_a_multigrids_tpu_torch import __main__ as tcli

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--mode", "9", "--rows", "4", "--cols", "4", "--ntime", "2"]


def _cli_matches_jax(argv, capsys):
    """The port's JSON line has every key of the JAX CLI's, with the same
    values (floats at rel 1e-9), and krylov_iterations exactly when a
    Krylov step ran (modes 7 and 9 with --krylov)."""
    jcli.main(argv + ["--cpu", "--f64"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tcli.main(argv + ["--device", "cpu", "--f64"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert set(want) <= set(got)
    for key, val in want.items():
        if key == "wall_s":
            continue
        if isinstance(val, int):
            assert got[key] == val, key
        else:
            assert got[key] == pytest.approx(val, rel=1e-9), key
    mode = int(argv[argv.index("--mode") + 1])
    assert ("krylov_iterations" in got) == ("--krylov" in argv
                                            and mode in (7, 9))
    return got


@pytest.mark.parametrize("extra", [[], ["--krylov", "--dt", "1e8"]],
                         ids=["vcycle", "pcg"])
def test_cli_matches_jax(extra, capsys):
    _cli_matches_jax(SMALL + extra, capsys)


@pytest.mark.parametrize("argv", [
    # the defaults: the 20 x 20 mesh's 9,600-DOF geometric coarsest is
    # above the dense cap, so SA levels continue below it (coarse_agg)
    ["--mode", "9"],
    # the production solver, SA-corrected PCG, at a small size
    ["--mode", "9", "--rows", "8", "--cols", "8", "--levels", "1", "--amg",
     "--agg-strength", "0.5", "--cheb-degree", "16", "--cheb-lower", "0.05",
     "--dt", "0.05", "--krylov", "--krylov-tol", "1e-6", "--ntime", "2"],
], ids=["defaults", "amg_krylov"])
def test_sa_cli_matches_jax(argv, capsys):
    got = _cli_matches_jax(argv, capsys)
    if "--amg" in argv:
        assert all(it > 0 for it in got["krylov_iterations"])


@pytest.mark.parametrize("argv", [
    # modes 2-8 and 10 and the theta-scheme / BiCGStab paths of mode 9
    ["--mode", "2", "--rows", "4", "--cols", "4", "--u", "1", "0.5"],
    ["--mode", "3", "--rows", "4", "--cols", "4"],
    ["--mode", "6", "--rows", "4", "--cols", "4", "--u", "1", "0",
     "--theta", "0.5", "--ntime", "3"],
    ["--mode", "7", "--rows", "4", "--cols", "4"],
    ["--mode", "8", "--rows", "4", "--cols", "4"],
    ["--mode", "10", "--rows", "4", "--cols", "4", "--dt", "0.05"],
    SMALL + ["--theta", "0.5"],
    SMALL + ["--krylov", "--u", "1", "0", "--dt", "0.01"],
], ids=["mode2", "mode3", "mode6_u", "mode7", "mode8", "mode10",
        "mode9_theta", "mode9_bicgstab"])
def test_modes_cli_matches_jax(argv, capsys):
    got = _cli_matches_jax(argv, capsys)
    if "--u" in argv and "--krylov" in argv:
        assert all(it > 0 for it in got["krylov_iterations"])


@pytest.mark.parametrize("argv", [
    ["--mode", "1"], ["--solver", "richardson"], ["--mesh", "m.geo"],
    ["--vtu", "o.vtu"], ["--vtk-interval", "2"], ["--checkpoint", "c.npz"],
    ["--ic", "x"], ["--bc", "x"], ["--source", "x"], ["--debug"],
    ["--devices", "2"], ["--solver", "gauss_seidel"],
    ["--solver", "jacobi"], ["--analytical", "x"],
], ids=lambda a: "_".join(a).strip("-"))
def test_unported_flags_exit_with_message(argv):
    with pytest.raises(SystemExit) as exc:
        tcli.main(SMALL + ["--device", "cpu"] + argv)
    assert "not ported" in str(exc.value.code)


def test_cuda_device_without_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(SMALL)


def test_runs_with_jax_blocked():
    """Importing and running the port never touches jax or the JAX
    package."""
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "from p_a_multigrids_tpu_torch import __main__ as cli\n"
        "out = cli.main(['--rows', '2', '--cols', '2', '--n-split', '1',"
        " '--levels', '2', '--ntime', '1', '--device', 'cpu'])\n"
        "assert 'p_a_multigrids_tpu' not in sys.modules\n"
        "assert out['L1_error'] == out['L1_error']\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["mode"] == 9


def test_sources_free_of_jax():
    files = sorted((REPO / "p_a_multigrids_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = re.compile(r"^\s*(import jax|from jax|import p_a_multigrids_tpu\b"
                     r"(?!_torch)|from p_a_multigrids_tpu\b(?!_torch))",
                     re.M)
    assert len(files) > 15
    for f in files:
        assert not bad.search(f.read_text()), f

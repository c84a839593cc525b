"""The port's CLI == the JAX package's CLI (float64, CPU) in modes 1-10
and with every --solver; --profile writes a torch.profiler trace; the port
runs with jax blocked."""

import torch_threads  # noqa: F401

import ast
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import threadpoolctl
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


# the reference's active mode-9 configuration
REFERENCE_MODE9 = ["--solver", "jacobi", "--omega", "0.8",
                   "--no-surface-terms", "--restrictor", "corner_average",
                   "--n-multigrid", "6"]


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
    # mode 1 (the moving box) and the solver menu of mode 9
    ["--mode", "1", "--rows", "40", "--cols", "2"],
    SMALL + REFERENCE_MODE9,
    SMALL + ["--solver", "gauss_seidel", "--omega", "0.5"],
], ids=["mode2", "mode3", "mode6_u", "mode7", "mode8", "mode10",
        "mode9_theta", "mode9_bicgstab", "mode1", "mode9_reference",
        "mode9_gauss_seidel"])
def test_modes_cli_matches_jax(argv, capsys):
    got = _cli_matches_jax(argv, capsys)
    if "--u" in argv and "--krylov" in argv:
        assert all(it > 0 for it in got["krylov_iterations"])


def test_n_split7_cli_matches_recorded_jax():
    """The non-stencil path at n_split 7 (2 macros of C = 16,384, 98,304
    DOF) on the port's CLI == the JAX CLI's values, recorded from
    ``python -m p_a_multigrids_tpu --mode 9 --n-split 7 --rows 1 --cols 1
    --levels 2 --ntime 1 --cpu --f64`` (it takes about 25 s there, too long
    to rerun here; tests/test_torch_semi.py holds the same code at n_split
    2 through stencil_operator=False against the live JAX package).  The
    JAX CLI ran its fused path there, below its stencil cap of 4,096
    children; the port's CLI takes it with the same cap in its
    configuration (``utils.profiling.cli_stencil_cap``), since its own
    default takes the stencil path at n_split 7."""
    from p_a_multigrids_tpu_torch.utils import profiling
    with profiling.cli_stencil_cap(4096):
        got = tcli.main(["--mode", "9", "--n-split", "7", "--rows", "1",
                         "--cols", "1", "--levels", "2", "--ntime", "1",
                         "--cpu", "--f64"])
    assert got["children"] == 16384 and got["elements"] == 2
    assert got["residual_history"] == pytest.approx([0.5774056933010983],
                                                    rel=1e-9)
    assert got["L1_error"] == pytest.approx(0.7638581222497288, rel=1e-9)


def test_jax_only_flags_parse(capsys):
    """--cpu is --device cpu; --checkpoint-every and --dist-ghost-frac
    parse (they matter only beside --checkpoint and --devices): a JAX
    command line that uses them runs and prints the same keys."""
    plain = tcli.main(SMALL + ["--device", "cpu"])
    got = tcli.main(SMALL + ["--cpu", "--checkpoint-every", "5",
                             "--dist-ghost-frac", "0.3"])
    capsys.readouterr()
    assert set(got) == set(plain)
    assert got["residual_history"] == plain["residual_history"]


PROFILED = ["--mode", "9", "--rows", "8", "--cols", "8", "--levels", "1",
            "--amg", "--krylov", "--device", "cpu"]


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_profile_writes_a_trace(tmp_path, capsys):
    """--profile DIR on the CPU: a Chrome trace in DIR, profile_dir and
    the run's counters in the JSON line, and the same numbers as the run
    without the trace."""
    logdir = str(tmp_path / "prof")
    got = tcli.main(PROFILED + ["--profile", logdir])
    plain = tcli.main(PROFILED)
    capsys.readouterr()
    assert got["profile_dir"] == logdir
    assert _trace_events(tmp_path / "prof" / "trace.json")
    assert set(got) == set(plain) | {"profile_dir", "counters"}
    for key in ("residual_history", "krylov_iterations", "L1_error"):
        assert got[key] == plain[key], key
    counters = got["counters"]
    its = got["krylov_iterations"]
    assert counters["counters"]["steps"] == len(its)
    assert counters["counters"]["host_syncs"] == sum(2 * i + 1 for i in its)
    assert counters["spans"]["pamg.step"]["calls"] == len(its)


def test_profile_keys_match_jax(tmp_path, capsys):
    """The same command line with --profile gives the JAX CLI's keys, and
    the port's counters."""
    argv = SMALL + ["--profile", str(tmp_path)]
    jcli.main(argv + ["--cpu", "--f64"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tcli.main(argv + ["--device", "cpu", "--f64"])
    capsys.readouterr()
    assert set(got) == set(want) | {"counters"}
    assert got["profile_dir"] == want["profile_dir"] == str(tmp_path)
    assert got["residual_history"] == pytest.approx(
        want["residual_history"], rel=1e-9)


def test_profile_trace_closes_when_the_solve_raises(tmp_path):
    """A solve that raises (a NaN initial condition under --debug) still
    leaves a complete trace."""
    with pytest.raises(FloatingPointError):
        with np.errstate(invalid="ignore"):
            tcli.main(SMALL + ["--device", "cpu", "--debug", "--ic",
                               "sqrt(-1-x)", "--profile", str(tmp_path)])
    assert _trace_events(tmp_path / "trace.json")


def test_devices_profile_writes_a_trace_a_rank(tmp_path, capsys):
    got = tcli.main(SMALL + ["--device", "cpu", "--devices", "2",
                             "--profile", str(tmp_path)])
    capsys.readouterr()
    assert got["profile_dir"] == str(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "trace_rank0.json", "trace_rank1.json"]
    for r in range(2):
        assert _trace_events(tmp_path / f"trace_rank{r}.json")


@pytest.mark.parametrize("argv", [
    ["--devices", "2"], ["--devices", "2", "--dist-ghost-frac", "0.5"],
], ids=lambda a: "_".join(a).strip("-"))
def test_cli_devices_runs_on_cpu_ranks(argv, capsys):
    """--devices N runs mode 9 on N CPU ranks and prints the JAX CLI's keys
    of that path."""
    got = tcli.main(SMALL + ["--device", "cpu"] + argv)
    capsys.readouterr()
    assert set(got) == {"mode", "devices", "elements", "children",
                        "L1_error", "wall_s"}
    assert got["devices"] == 2 and got["elements"] == 32
    assert np.isfinite(got["L1_error"])


def test_cuda_device_without_card_exits():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(SMALL)


@pytest.mark.parametrize("argv", [
    ["--mode", "9"], ["--mode", "9", "--amg", "--krylov", "--debug"],
    ["--mode", "6", "--profile", "prof"], ["--mode", "9", "--devices", "2"],
    ["--mode", "1"], ["--mode", "10"]],
    ids=["mode9", "mode9_amg_debug", "mode6_profile", "devices", "mode1",
         "mode10"])
def test_f64_parses_for_the_card(argv, monkeypatch):
    """--f64 --device cuda is accepted (kernels K1 and K2 take float64),
    and every configuration the CLI builds gets float64."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args, device = tcli._parse(argv + ["--f64", "--device", "cuda"])
    assert device.type == "cuda" and args.f64
    for build in (tcli._semi_cfg, tcli._transport_cfg, tcli._rect_cfg):
        assert build(args).dtype == "float64", build.__name__
    args, _ = tcli._parse(argv + ["--device", "cuda"])
    for build in (tcli._semi_cfg, tcli._transport_cfg, tcli._rect_cfg):
        assert build(args).dtype == "float32", build.__name__


@pytest.mark.parametrize("extra,mode", [
    ([], 9), (["--solver", "jacobi"], 9), (["--mode", "1"], 1),
    (["--debug", "--ic", "x*y", "--analytical", "x", "--vtk-interval",
      "1", "--vtu", "{tmp}/x.vtu", "--checkpoint", "{tmp}/c.npz"], 9)],
    ids=["mode9", "mode9_jacobi", "mode1", "mode9_debug_expressions_io"])
def test_runs_with_jax_blocked(extra, mode, tmp_path):
    """Importing and running the port never touches jax or the JAX
    package."""
    argv = ["--rows", "2", "--cols", "2", "--n-split", "1", "--levels", "2",
            "--ntime", "1", "--device", "cpu"] + [
                a.format(tmp=tmp_path) for a in extra]
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "from p_a_multigrids_tpu_torch import __main__ as cli\n"
        f"out = cli.main({argv!r})\n"
        "assert 'p_a_multigrids_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["mode"] == mode
    key = "t_range" if mode == 1 else "L1_error"
    assert all(v == v for v in np.atleast_1d(out[key]))


def test_sources_free_of_jax():
    files = sorted((REPO / "p_a_multigrids_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = re.compile(r"^\s*(import jax|from jax|import p_a_multigrids_tpu\b"
                     r"(?!_torch)|from p_a_multigrids_tpu\b(?!_torch))",
                     re.M)
    assert len(files) > 15
    for f in files:
        assert not bad.search(f.read_text()), f


def test_port_tests_run_on_one_thread():
    """tests/torch_threads.py holds in this process and its children, and
    every port test file imports it first."""
    assert torch.get_num_threads() == 1
    pools = threadpoolctl.threadpool_info()
    assert pools and all(p["num_threads"] == 1 for p in pools), pools
    env = subprocess.run(
        [sys.executable, "-c", "import os; print(os.environ"
         "['OMP_NUM_THREADS'], os.environ['OPENBLAS_NUM_THREADS'],"
         " os.environ['MKL_NUM_THREADS'])"],
        capture_output=True, text=True, check=True).stdout.split()
    assert env == ["1", "1", "1"]
    files = sorted((REPO / "tests").glob("test_torch_*.py"))
    assert len(files) > 30
    for f in files:
        first = next(n for n in ast.parse(f.read_text()).body
                     if isinstance(n, (ast.Import, ast.ImportFrom)))
        assert (isinstance(first, ast.Import)
                and [a.name for a in first.names] == ["torch_threads"]), f

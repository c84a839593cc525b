"""The port's public surface is the JAX package's, read from both packages'
sources with ``ast``: every public top-level function, class and constant
of each JAX module, and every public method of its classes, has a
counterpart of the same name in the same module of the port, apart from
the TPU mechanisms listed in ``LEFT_OUT``; the two CLIs take the same
options apart from the port's ``--device``; each subpackage imports the
same submodules; and no ``device`` parameter of the port defaults to the
CPU.  The JAX system's two root surfaces have theirs too: every key of
``bench.py``'s JSON line is a key of the port bench's (``bench.py``'s TPU
names under the port's, ``RENAMED``), and each public function of
``__graft_entry__.py`` is a function of the port's ``entry`` module.  The
JAX system's three distributed measurement scripts have one counterpart,
``bench_dist``: every key of each script's JSON is a key of its section of
the port's line (``DIST_RENAMED``), which the test runs on CPU ranks at a
small size (~15 s; the rest of the file reads sources only).  And
``scripts/tune_amg.py`` has ``tune_amg``: the same cases, the same
configuration, and a JSON key for each field the script prints
(``TUNE_FIELDS``)."""

import torch_threads  # noqa: F401

import argparse
import ast
import contextlib
import io
import json
import pathlib

import pytest

from p_a_multigrids_tpu import __main__ as jcli

from p_a_multigrids_tpu_torch import __main__ as tcli
from p_a_multigrids_tpu_torch import bench_dist, tune_amg

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX = REPO / "p_a_multigrids_tpu"
PORT = REPO / "p_a_multigrids_tpu_torch"

# The mechanisms the TPU forced, which the port leaves out on purpose
# (ROADMAP.md, queue 1, "Left out on purpose"): a JAX module or name, with
# its counterpart in the port or the reason it has no job on the card.
LEFT_OUT = {
    "models.semi.pack_x_t": "relabelling for Mosaic grid steps: the port "
                            "runs the (3, C, U) layout unpacked",
    "models.semi.unpack_x_t": "as pack_x_t",
    "ops.stencil.pack_stencil": "macro packing for Mosaic grid steps: "
                                "--coarse-pack is accepted and does nothing",
    "ops.stencil.StencilOperator.strip": "strip packing for the TPU kernel: "
                                         "K1 reads each strip slot's source "
                                         "by index (StencilOperator.src_cu)",
    "ops.banding": "the Mosaic band windows (aligned_band): K2 reads any "
                   "column by index",
    "ops.pallas_bsr": "PallasSpMV and spmv_fast: ops.spmv.RowOp and "
                      "ops.spmv.rowop (kernel K2, csrc/spmv.cu)",
    "ops.pallas_stencil": "PhaseOperator*, make_phase: ops.phase.phase over "
                          "ops.stencil.StencilOperator (kernel K1, "
                          "csrc/phase.cu)",
    "utils.debugging.ERRORS": "jax checkify's error set: the checked builds "
                              "of K1 and K2 (utils.debugging.Sanitizer, "
                              "-DPAMG_CHECKED)",
}


# bench.py's JSON keys that name a TPU mechanism, and the port's for them
RENAMED = {"pallas_spmv": "k2_spmv", "pallas_phase": "k1_phase",
           "pallas_phase_impl": "k1_tiers",
           "spmv_xla_gnnz_s": "spmv_library_gnnz_s"}


def _modules(root: pathlib.Path) -> dict:
    """{dotted module name: parsed source} of a package."""
    return {".".join(f.relative_to(root).with_suffix("").parts):
            ast.parse(f.read_text())
            for f in sorted(root.rglob("*.py"))}


JAX_MODULES = _modules(JAX)
PORT_MODULES = _modules(PORT)

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _assigned(node) -> list:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _public(name: str) -> bool:
    return not name.startswith("_")


def defined(tree) -> set:
    """The public names a JAX module defines: its functions, classes and
    constants, and ``Class.method`` for each public method of a public
    class (imports are not its own)."""
    out = set()
    for node in tree.body:
        if isinstance(node, _DEFS) and _public(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, _DEFS[:2]) and _public(m.name)}
        out |= {n for n in _assigned(node) if _public(n)}
    return out


def bound(tree) -> set:
    """Every name a port module binds at top level (definitions,
    assignments and imports), and ``Class.attr`` for each name bound in a
    class body."""
    out = set()
    for node in tree.body:
        if isinstance(node, _DEFS):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    names = ([m.name] if isinstance(m, _DEFS)
                             else _assigned(m))
                    out |= {f"{node.name}.{n}" for n in names}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        out |= set(_assigned(node))
    return out


@pytest.mark.parametrize("module", sorted(
    m for m, tree in JAX_MODULES.items()
    if m not in LEFT_OUT and defined(tree)))
def test_module_has_the_jax_public_names(module):
    want = {n for n in defined(JAX_MODULES[module])
            if f"{module}.{n}" not in LEFT_OUT}
    assert module in PORT_MODULES, f"the port has no module {module}"
    missing = sorted(want - bound(PORT_MODULES[module]))
    assert not missing, f"{module}: the port lacks {missing}"


@pytest.mark.parametrize("entry", sorted(LEFT_OUT))
def test_left_out_entry_is_a_missing_jax_name(entry):
    """Each entry names a JAX module or name that the port still lacks, so
    the list cannot go stale."""
    if entry in JAX_MODULES:
        assert entry not in PORT_MODULES, f"the port now has {entry}"
        return
    module, name = next(((m, entry[len(m) + 1:]) for m in JAX_MODULES
                         if entry.startswith(m + ".")
                         and entry[len(m) + 1:] in defined(JAX_MODULES[m])),
                        (None, None))
    assert module is not None, f"the JAX package has no {entry}"
    assert name not in bound(PORT_MODULES.get(module, ast.Module([], []))), \
        f"the port now has {entry}"


def _option_strings(parser: argparse.ArgumentParser) -> set:
    return {s for a in parser._actions for s in a.option_strings}


class _Parsed(Exception):
    pass


def test_cli_options_match_jax(monkeypatch):
    """The JAX CLI builds its parser inside ``main``: stop it at
    ``parse_args`` and read the parser it built."""
    built = []

    def stop(self, *args, **kwargs):
        built.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed):
        jcli.main([])
    monkeypatch.undo()
    want = _option_strings(built[0])
    got = _option_strings(tcli._parser())
    assert "--help" in want and "--device" not in want
    assert got - {"--device"} == want


def _init_imports(tree) -> set:
    return {a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            and node.level == 1 and node.module is None for a in node.names}


@pytest.mark.parametrize("package", sorted(
    m[:-len(".__init__")] for m in JAX_MODULES if m.endswith(".__init__")))
def test_subpackage_imports_the_jax_submodules(package):
    init = f"{package}.__init__"
    want = _init_imports(JAX_MODULES[init])
    missing = sorted(want - _init_imports(PORT_MODULES[init]))
    assert not missing, f"{package}/__init__.py does not import {missing}"


def _cpu(default) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` (also with an index)."""
    if isinstance(default, ast.Constant):
        return default.value == "cpu"
    return (isinstance(default, ast.Call) and default.args
            and ast.unparse(default.func).split(".")[-1] == "device"
            and isinstance(default.args[0], ast.Constant)
            and default.args[0].value == "cpu")


def test_no_device_parameter_defaults_to_the_cpu():
    found = []
    for module, tree in PORT_MODULES.items():
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                continue
            a = fn.args
            pos = a.posonlyargs + a.args
            pairs = (list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
                     + list(zip(a.kwonlyargs, a.kw_defaults)))
            found += [f"{module}:{fn.lineno} {arg.arg}" for arg, d in pairs
                      if arg.arg == "device" and d is not None and _cpu(d)]
    assert not found, f"device defaults to the CPU: {found}"


def result_keys(path: pathlib.Path) -> set:
    """The dotted keys of the dict literal a file assigns to ``result``,
    into its nested dict literals (of a conditional value, the first
    branch)."""
    tree = ast.parse(path.read_text())
    node = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and [ast.unparse(t) for t in n.targets] == ["result"])

    def keys(node, prefix: str) -> set:
        if isinstance(node, ast.IfExp):
            node = node.body
        if not isinstance(node, ast.Dict):
            return set()
        out = set()
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant):
                out |= {prefix + k.value} | keys(v, f"{prefix}{k.value}.")
        return out

    return keys(node, "")


def test_bench_json_has_the_bench_py_keys():
    want = {".".join(RENAMED.get(p, p) for p in k.split("."))
            for k in result_keys(REPO / "bench.py")}
    got = result_keys(PORT / "bench.py")
    assert len(want) > 20 and "extra.geometric.rho" in want
    missing = sorted(want - got)
    assert not missing, f"the port's bench JSON lacks {missing}"
    tpu = sorted(k for k in got if k.split(".")[-1] in RENAMED)
    assert not tpu, f"the port's bench JSON keeps the TPU names {tpu}"


def test_graft_entry_functions_have_counterparts():
    graft = ast.parse((REPO / "__graft_entry__.py").read_text())
    want = {n.name for n in graft.body
            if isinstance(n, ast.FunctionDef) and _public(n.name)}
    assert want == {"entry", "dryrun_multichip"}
    missing = sorted(want - bound(PORT_MODULES["entry"]))
    assert not missing, f"the port's entry module lacks {missing}"


# the JAX distributed scripts, the port's section of each, and their TPU
# names under the port's (a key named after D = 8 carries the run's N, or
# the model's M)
DIST_SCRIPTS = {"bench_dist8.py": "dist8", "bench_dist_tpu.py": "retention",
                "bench_distributed.py": "overhead"}
DIST_RENAMED = {"pallas": "kernels", "pallas_phase_dist": "k1_phase_dist",
                "ideal_speedup_at_D8": "ideal_speedup_at_D{N}",
                "ghost_model_at_D8": "ghost_model_at_D{M}"}


def _path(node) -> list | None:
    """The keys of a subscript chain ``name[k1][k2]`` ("*" for a key that
    is not a constant), or [] for a bare name."""
    keys = []
    while isinstance(node, ast.Subscript):
        k = node.slice
        keys.append(k.value if isinstance(k, ast.Constant) else "*")
        node = node.value
    return keys[::-1] if isinstance(node, ast.Name) else None


def script_json_keys(path: pathlib.Path) -> set:
    """The dotted keys of the JSON a script writes: of every dict literal
    it assigns to a name or a subscript of one (into nested dict
    literals), and of the ``dict(...)`` records of a function that fills a
    key's list ("*" for a list's item or a non-constant key)."""
    tree = ast.parse(path.read_text())
    records = {f.name: {kw.arg for c in ast.walk(f) if isinstance(c, ast.Call)
                        and ast.unparse(c.func) == "dict"
                        for kw in c.keywords}
               for f in tree.body if isinstance(f, ast.FunctionDef)}

    def keys(node, prefix: str) -> set:
        if isinstance(node, ast.Call) and records.get(
                ast.unparse(node.func)):
            return {f"{prefix}*.{k}" for k in records[ast.unparse(node.func)]}
        if not isinstance(node, ast.Dict):
            return set()
        out = set()
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant):
                out |= {prefix + k.value} | keys(v, f"{prefix}{k.value}.")
        return out

    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            for t in node.targets:
                path = _path(t)
                if path is not None:
                    out |= keys(node.value, "".join(f"{k}." for k in path))
    return out


def line_keys(obj, prefix: str = "") -> set:
    """The dotted keys of a JSON value: "*" for a list's item and for each
    configuration under ``configs``."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            name = "*" if prefix.endswith("configs.") else k
            out |= {prefix + name} | line_keys(v, f"{prefix}{name}.")
    elif isinstance(obj, list):
        for v in obj:
            out |= line_keys(v, f"{prefix}*.")
    return out


def test_dist_scripts_keys_are_read():
    keys = {s: script_json_keys(REPO / "scripts" / s) for s in DIST_SCRIPTS}
    assert {"configs.*.ghost_report", "configs.*.ideal_speedup_at_D8",
            "pallas", "backend"} <= keys["bench_dist8.py"]
    assert {"configs.*.ghost_model_at_D8.*.deep_ghost_frac",
            "configs.*.pallas_phase_dist"} <= keys["bench_dist_tpu.py"]
    assert {"halo_window_W", "overhead_factor"} <= keys[
        "bench_distributed.py"]


@pytest.fixture(scope="module")
def dist_lines():
    """The port's distributed bench on the CPU at a small size, one window
    of one call: at --devices 2 (dist8, overhead) and 1 (retention)."""
    lines = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_dist, "DIST8_MESH", (8, 4, 0.25, 0.25))
        mp.setattr(bench_dist, "OVERHEAD_MESH", (4, 4, 0.25, 0.25))
        for name in ("DIST8_CYCLES", "RETENTION_CYCLES", "OVERHEAD_STEPS",
                     "REPS"):
            mp.setattr(bench_dist, name, 1)
        for n in (2, 1):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = bench_dist.main(["--device", "cpu", "--devices", str(n)])
            assert rc == 0
            lines[n] = json.loads(buf.getvalue())
    return lines


@pytest.mark.parametrize("script", list(DIST_SCRIPTS))
def test_bench_dist_json_has_the_scripts_keys(dist_lines, script):
    section = DIST_SCRIPTS[script]
    n = 1 if section == "retention" else 2
    got = line_keys(dist_lines[n][section])
    rename = {k: v.format(N=n, M=8) for k, v in DIST_RENAMED.items()}
    want = {".".join(rename.get(p, p) for p in k.split("."))
            for k in script_json_keys(REPO / "scripts" / script)}
    missing = sorted(want - got)
    assert not missing, f"the port's {section} section lacks {missing}"
    tpu = sorted(k for k in got if "pallas" in k)
    assert not tpu, f"the port's {section} section keeps the TPU names {tpu}"
    assert dist_lines[n][section]["backend"] == "gloo"
    text = json.dumps(dist_lines[n])
    assert "cpu-virtual" not in text and "interpret" not in text


# each value scripts/tune_amg.py prints for a case (the names in its
# f-string) and the key of the port's row that carries it
TUNE_FIELDS = {"name": "name", "per": "ms_per_cycle", "rho": "rho",
               "t6": "ms_to_1e6", "its": "pcg_its_to_1e6",
               "pms": "pcg_ms_to_1e6", "setup": "setup_s"}


def _tune_main():
    tree = ast.parse((REPO / "scripts" / "tune_amg.py").read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def test_tune_amg_cases_are_the_scripts():
    """The script's ``cases`` literal (its ``dict(...)`` knobs read by
    ``ast.literal_eval``) and the ``SemiConfig`` fields of its loop."""
    main = _tune_main()
    node = next(n.value for n in main.body if isinstance(n, ast.Assign)
                and [getattr(t, "id", None) for t in n.targets] == ["cases"])
    cases = [(ast.literal_eval(name), {k.arg: ast.literal_eval(k.value)
                                       for k in knobs.keywords})
             for name, knobs in (e.elts for e in node.elts)]
    assert len(cases) == 7 and cases == tune_amg.CASES
    call = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "SemiConfig")
    base = {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg is not None}
    assert base == {**tune_amg.BASE, "ntime": 1, "n_multigrid": 1,
                    "dtype": "float32"}


def test_tune_amg_json_has_the_printed_fields():
    printed = next(n for n in ast.walk(_tune_main())
                   if isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == "print"
                   and "ms/cyc" in ast.unparse(n))
    names = {m.id for v in ast.walk(printed.args[0])
             if isinstance(v, ast.FormattedValue)
             for m in ast.walk(v.value) if isinstance(m, ast.Name)}
    assert names == set(TUNE_FIELDS)
    tree = ast.parse((PORT / "tune_amg.py").read_text())
    run_case = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                    and n.name == "run_case")
    row = next(n.value for n in ast.walk(run_case)
               if isinstance(n, ast.Return))
    keys = {k.value for k in row.keys}
    missing = sorted(set(TUNE_FIELDS.values()) - keys)
    assert not missing, f"the port's tune_amg rows lack {missing}"

"""The port's public surface is the JAX package's, read from both packages'
sources with ``ast``: every public top-level function, class and constant
of each JAX module, and every public method of its classes, has a
counterpart of the same name in the same module of the port, apart from
the TPU mechanisms listed in ``LEFT_OUT``; the two CLIs take the same
options apart from the port's ``--device``; each subpackage imports the
same submodules; and no ``device`` parameter of the port defaults to the
CPU."""

import argparse
import ast
import pathlib

import pytest

from p_a_multigrids_tpu import __main__ as jcli

from p_a_multigrids_tpu_torch import __main__ as tcli

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

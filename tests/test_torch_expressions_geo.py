"""The port's expression evaluator and .geo mesher == the JAX package's,
bit for bit, and the CLI's expression flags and .geo meshes == the JAX
CLI's (float64, CPU, rel 1e-9)."""

import torch_threads  # noqa: F401

import json

import numpy as np
import pytest

from p_a_multigrids_tpu import __main__ as jcli
from p_a_multigrids_tpu.mesh import geo as jgeo
from p_a_multigrids_tpu.utils import expressions as jexpr

from p_a_multigrids_tpu_torch import __main__ as tcli
from p_a_multigrids_tpu_torch.mesh import geo as tgeo
from p_a_multigrids_tpu_torch.utils import expressions as texpr

# the strings of tests/test_expressions_geo.py's evaluator cases
SCALARS = ["2 + 3 * 4", "(2 + 3) * 4", "2 ^ 3 ^ 2", "2 ** 3", "-2^2",
           "7 / 2 / 2", "sin(pi/2)", "exp(1)", "atan2(1, 1)",
           "max(2, 3) + min(2, 3)", "erfc(0)", "--+-3 * e"]
ERRORS = ["import os", "x.__class__", "unknown_fn(x)", "x + ", "x + z",
          "eval(x)", "__import__(x)", "sin(x", "1 2", "x $ y"]
# an argument string for every function of the table, on points in its
# domain
FUNCTION_CALLS = {
    "sin": "sin(x)", "cos": "cos(x)", "tan": "tan(x)",
    "asin": "asin(x / 4)", "acos": "acos(x / 4)", "atan": "atan(x)",
    "atan2": "atan2(x, y)", "sinh": "sinh(x)", "cosh": "cosh(x)",
    "tanh": "tanh(x)", "exp": "exp(x)", "log": "log(y + 1)",
    "log10": "log10(y + 1)", "sqrt": "sqrt(y)", "abs": "abs(x)",
    "sign": "sign(x)", "floor": "floor(3 * x)", "ceil": "ceil(3 * x)",
    "min": "min(x, y)", "max": "max(x, y)", "erf": "erf(x)",
    "erfc": "erfc(x)", "heaviside": "heaviside(x)",
    "where": "where(x, y, -y)"}

SQUARE_GEO = """
lc = 0.25;
Point(1) = {0, 0, 0, lc};
Point(2) = {1, 0, 0, lc};
Point(3) = {1, 1, 0, lc};
Point(4) = {0, 1, 0, lc};
Line(1) = {1, 2};
Line(2) = {2, 3};
Line(3) = {3, 4};
Line(4) = {4, 1};
Line Loop(5) = {1, 2, 3, 4};
Plane Surface(6) = {5};
Physical Surface(100) = {6};
"""

ANNULUS_GEO = """
lc = 0.3;
Point(1) = {0, 0, 0, lc};
Point(2) = {1, 0, 0, lc};
Point(3) = {-1, 0, 0, lc};
Point(4) = {0.4, 0, 0, lc};
Point(5) = {-0.4, 0, 0, lc};
Circle(1) = {2, 1, 3};
Circle(2) = {3, 1, 2};
Circle(3) = {4, 1, 5};
Circle(4) = {5, 1, 4};
Line Loop(10) = {1, 2};
Line Loop(11) = {3, 4};
Plane Surface(20) = {10, 11};
"""


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_expressions_match(text):
    _same(texpr.evaluate(text), jexpr.evaluate(text))


def test_tables_match():
    assert set(texpr._FUNCTIONS) == set(jexpr._FUNCTIONS)
    assert texpr._CONSTANTS == jexpr._CONSTANTS
    assert set(FUNCTION_CALLS) == set(texpr._FUNCTIONS)


@pytest.mark.parametrize("name", sorted(FUNCTION_CALLS))
def test_functions_match_on_seeded_points(name):
    """Each function of the table on 257 seeded points (x in [-3, 3], y in
    [0, 2]), bit for bit."""
    rng = np.random.default_rng(7)
    x, y = rng.uniform(-3, 3, 257), rng.uniform(0, 2, 257)
    text = FUNCTION_CALLS[name]
    _same(texpr.Expression(text)(x, y), jexpr.Expression(text)(x, y))


def test_variables_parameters_and_broadcast_match():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(7, 1))
    y = rng.uniform(size=(1, 5))
    for text, params in (("sin(x + y)", None),
                         ("k * x - y / k ^ 2", {"k": 2.5}),
                         ("2 * 1.0 * sin(x + y)", None), ("0", None),
                         ("exp(-k * x) * sin(pi * y)", {"k": 0.5})):
        _same(texpr.Expression(text, parameters=params)(x, y),
              jexpr.Expression(text, parameters=params)(x, y))
    assert repr(texpr.Expression("x*y")) == repr(jexpr.Expression("x*y"))


@pytest.mark.parametrize("text", ERRORS)
def test_errors_match(text):
    with pytest.raises(jexpr.ExpressionError) as want:
        jexpr.Expression(text)
    with pytest.raises(texpr.ExpressionError) as got:
        texpr.Expression(text)
    assert str(got.value) == str(want.value)
    assert not isinstance(got.value, jexpr.ExpressionError)
    with pytest.raises(texpr.ExpressionError, match="takes 2 args"):
        texpr.Expression("x")(1.0)


def _mesh_fields_equal(t, j):
    for field in ("X", "tri", "neig", "neigh_face", "dir_flag",
                  "region_id"):
        _same(getattr(t, field), getattr(j, field))


@pytest.mark.parametrize("text,h", [(SQUARE_GEO, None), (ANNULUS_GEO, 0.25),
                                    (ANNULUS_GEO, None)],
                         ids=["square", "annulus_h", "annulus_lc"])
def test_mesh_geo_matches(text, h):
    t, j = tgeo.mesh_geo(text, h=h), jgeo.mesh_geo(text, h=h)
    _mesh_fields_equal(t, j)
    tg, jg = tgeo.read_geo(text), jgeo.read_geo(text)
    assert tg.params == jg.params and tg.loops == jg.loops
    assert tg.surfaces == jg.surfaces and tg.physical == jg.physical
    for pid in jg.points:
        _same(tg.points[pid], jg.points[pid])


def test_geo_file_path_matches(tmp_path):
    path = tmp_path / "square.geo"
    path.write_text(SQUARE_GEO)
    _mesh_fields_equal(tgeo.mesh_geo(str(path)), jgeo.mesh_geo(str(path)))
    with pytest.raises(ValueError, match="no Plane Surface"):
        tgeo.mesh_geo("lc = 1;\nPoint(1) = {0, 0, 0, lc};")


def _cli_pair(argv, capsys):
    jcli.main(argv + ["--cpu", "--f64"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tcli.main(argv + ["--device", "cpu", "--f64"])
    capsys.readouterr()
    return want, got


def _hold(want, got, keys=("L1_error", "residual", "residual_history")):
    for key in keys:
        assert got[key] == pytest.approx(want[key], rel=1e-9), key


# tests/test_cli.py's expression-flag case
EXPR_ARGS = ["--mode", "9", "--rows", "6", "--cols", "6", "--n-split", "1",
             "--levels", "1", "--ntime", "6", "--dt", "100000.0",
             "--ic", "0", "--bc", "sin(x+y)", "--source", "2*sin(x+y)",
             "--analytical", "sin(x+y)"]


@pytest.mark.parametrize("extra", [
    [], ["--n-split", "2", "--levels", "2", "--krylov"],
    ["--ic", "sin(pi*x)*y", "--analytical", "0*x"],
], ids=["expressions", "krylov", "ic_only"])
def test_cli_expression_flags_match_jax(extra, capsys):
    want, got = _cli_pair(EXPR_ARGS + extra, capsys)
    _hold(want, got)


def test_cli_manufactured_rule(capsys):
    """Any of --ic/--bc/--source turns the manufactured problem off: with
    --ic alone there is no source, no boundary value and no analytical
    field, so the error is |T| (as in the JAX CLI)."""
    argv = ["--mode", "9", "--rows", "4", "--cols", "4", "--ntime", "1",
            "--ic", "x*y"]
    want, got = _cli_pair(argv, capsys)
    _hold(want, got)
    plain = tcli.main(argv[:-2] + ["--device", "cpu", "--f64"])
    capsys.readouterr()
    assert plain["L1_error"] != got["L1_error"]


@pytest.mark.parametrize("text", [SQUARE_GEO, ANNULUS_GEO],
                         ids=["square", "annulus"])
def test_cli_geo_mesh_matches_jax(text, tmp_path, capsys):
    path = tmp_path / "domain.geo"
    path.write_text(text)
    base = ["--mode", "9", "--mesh", str(path), "--n-split", "2",
            "--levels", "2", "--ntime", "2"]
    for extra in ([], EXPR_ARGS[-8:]):
        want, got = _cli_pair(base + extra, capsys)
        assert got["elements"] == want["elements"]
        _hold(want, got)

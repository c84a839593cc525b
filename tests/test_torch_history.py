"""The port's residual-history pins (validation/history.py,
history_pins.json, recorded by scripts/torch_record_history.py from the
JAX package): they cover the specs, are the JAX package's (one small spec
re-recorded live), the port reproduces every small pin in float64 within
1e-10 relative per cycle (plus twice the float64 evaluation floor), and
the pins have the shape of tests/test_history.py's level-sweep studies."""

import torch_threads  # noqa: F401

import os

import numpy as np
import pytest

from p_a_multigrids_tpu.mesh import geo as jgeo
from p_a_multigrids_tpu.mesh import structured as jstructured
from p_a_multigrids_tpu.mesh import topology as jtopology

from p_a_multigrids_tpu_torch import __main__ as tcli
from p_a_multigrids_tpu_torch.validation import history

SMALL_SPECS = [s for s in history.DEFAULT_SPECS
               if s not in history.LARGE_SPECS]


@pytest.fixture(scope="module")
def pins():
    return history.load_pins()


def test_pins_cover_default_specs(pins):
    assert list(pins) == [history.spec_key(*s)
                          for s in history.DEFAULT_SPECS]
    for key, rec in pins.items():
        assert len(rec["residual_linf"]) >= 10, key
        for field in ("rho", "num_macro", "x_hash", "f64_floor",
                      "f32_floor", "stand_in_for"):
            assert field in rec, (key, field)
        assert 0 <= rec["f64_floor"] <= min(rec["residual_linf"]), key
        assert rec["f32_floor"] > 0, key
    # the small specs' float64 histories reach their floor within 25
    # cycles (the bench stand-in's at level 1, rho 0.71, does not)
    for spec in SMALL_SPECS:
        rec = pins[history.spec_key(*spec)]
        assert rec["f32_floor"] > 1e4 * rec["f64_floor"], spec


@pytest.mark.parametrize("name", sorted(history.STAND_INS))
def test_stand_in_meshes_are_the_pinned_ones(name, pins):
    """Each stand-in made by the port is the mesh the JAX package recorded
    on (the same X), in both orders."""
    for levels in (1, "cli"):
        mesh = history.spec_mesh(name, levels)
        jmesh = history.spec_mesh(name, levels, structured=jstructured,
                                  geo=jgeo, topology=jtopology)
        np.testing.assert_array_equal(mesh.X, jmesh.X)
    for spec in history.DEFAULT_SPECS:
        if spec[0] == name:
            mesh = history.spec_mesh(name, spec[2])
            pin = pins[history.spec_key(*spec)]
            assert mesh.num_elements == pin["num_macro"]
            assert history.mesh_hash(mesh) == pin["x_hash"]


@pytest.mark.parametrize("spec", SMALL_SPECS,
                         ids=[history.spec_key(*s) for s in SMALL_SPECS])
def test_port_reproduces_pin(spec, pins):
    name, n_split, levels = spec
    got = history.record_zoo([spec])[history.spec_key(*spec)]
    pin = pins[history.spec_key(*spec)]
    assert history.hold(got["residual_linf"], pin, rel=1e-10,
                        floor="f64_floor") == []
    # tests/test_history.py's tolerance: rho weighs the last cycle, which
    # lies on the float64 floor in some histories
    assert abs(got["rho"] - pin["rho"]) < 1e-3
    assert got["num_macro"] == pin["num_macro"]
    assert got["x_hash"] == pin["x_hash"]


def _recorder():
    """scripts/torch_record_history.py as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "torch_record_history.py")
    spec = importlib.util.spec_from_file_location("torch_record_history",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_rerecords_a_pin_live(pins):
    """The pins are the JAX package's: test_sn2's stand-in at n_split 3 and
    2 levels, recorded again here by the JAX package through the recording
    script (the history, its float64 floor and its float32 evaluation
    floor)."""
    got = _recorder().record("tri_sn2", 3, 2)
    pin = pins["tri_sn2:s3:l2"]
    assert history.hold(got["residual_linf"], pin, rel=1e-12,
                        floor="f64_floor") == []
    for key in ("f64_floor", "f32_floor"):
        assert got[key] == pytest.approx(pin[key], rel=1e-6), key
    assert got["x_hash"] == pin["x_hash"]


@pytest.mark.parametrize("spec", SMALL_SPECS,
                         ids=[history.spec_key(*s) for s in SMALL_SPECS])
def test_port_float32_holds_pin(spec, pins):
    """The card's rule, here on the CPU: the port's float32 history holds
    the float64 pin within 2% plus twice its float32 evaluation floor."""
    from p_a_multigrids_tpu_torch.models import semi as msemi

    name, n_split, levels = spec
    pin = pins[history.spec_key(*spec)]
    solver = msemi.SemiSolver(msemi.build_problem(
        history.spec_mesh(name, levels),
        history.spec_config(n_split, levels)), "cpu")
    got = history.residual_history(solver, len(pin["residual_linf"]))
    assert history.hold(got, pin) == []


@pytest.mark.parametrize("key", ["tri_sn2:s3:l2", "tri_sn2:s3:amg"])
def test_port_float64_holds_pin_at_the_cards_tolerance(key, pins):
    """The card's float64 rule (chip_smoke.py phase 35), here on the CPU:
    the port's plain path in float64, through the solver a user builds,
    holds the JAX package's pin within history.F64_REL of each cycle plus
    twice its float64 floor."""
    from p_a_multigrids_tpu_torch.models import semi as msemi

    name, n_split, levels = key.split(":")
    levels = levels if levels == "amg" else int(levels[1:])
    pin = pins[key]
    solver = msemi.SemiSolver(msemi.build_problem(
        history.spec_mesh(name, levels),
        history.spec_config(int(n_split[1:]), levels, dtype="float64")),
        "cpu")
    got = history.residual_history(solver, len(pin["residual_linf"]))
    assert history.hold(got, pin, rel=history.F64_REL,
                        floor="f64_floor") == []


def test_hold_reports_failures(pins):
    pin = pins["tri_sn2:s3:amg"]
    w = pin["residual_linf"]
    assert history.hold(w, pin) == []
    bad = list(w)
    bad[1] *= 1.05
    assert len(history.hold(bad, pin)) == 1
    assert history.hold(w[:-1], pin) != []
    assert history.hold([np.nan] + w[1:], pin) != []


def test_multigrid_benefit_shape(pins):
    """Adding levels improves (or keeps) the contraction factor on every
    stand-in family, and the deepest hierarchy is materially better than
    one level (tests/test_history.py's shape)."""
    fams = {}
    for key, rec in pins.items():
        name, s, lv = key.split(":")
        if lv in ("amg", "cli"):
            continue
        fams.setdefault((name, s), []).append((int(lv[1:]), rec["rho"]))
    assert len(fams) == 3
    for (name, s), entries in fams.items():
        rhos = [r for _, r in sorted(entries)]
        for a, b in zip(rhos, rhos[1:]):
            assert b <= a * 1.05, (name, s, rhos)
        if len(rhos) >= 3:
            assert rhos[-1] < rhos[0], (name, s, rhos)


def test_histories_contract(pins):
    for key, rec in pins.items():
        assert 0 < rec["rho"] < 1, f"{key}: rho={rec['rho']}"
        r = np.asarray(rec["residual_linf"])
        assert r[-1] < r[0]


def test_cli_spec_is_the_cli_configuration(tmp_path):
    """The "cli" spec's configuration is what the CLI builds for
    ``--mesh annulus.geo --n-split 3 --krylov``, on the mesh the CLI
    loads."""
    path = tmp_path / "annulus.geo"
    path.write_text(history.ANNULUS_GEO)
    args = tcli._parse(history.CLI_ARGS + ["--mesh", str(path), "--n-split",
                                           "3", "--device", "cpu"])[0]
    cfg = tcli._semi_cfg(args)
    want = history.cli_config(3)
    for field in list(history.CLI_KW) + ["n_split", "physics", "solver",
                                         "manufactured", "dtype"]:
        assert getattr(cfg, field) == getattr(want, field), field
    assert (history.mesh_hash(tcli._mesh(args))
            == history.load_pins()["annulus_geo:s3:cli"]["x_hash"])

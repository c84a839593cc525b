"""The port's validation modules (numpy/scipy copies) are bit-identical to
the JAX package's ``validation/analytical.py``, ``gates.py`` and
``probe.py`` on seeded inputs."""

import torch_threads  # noqa: F401

import dataclasses

import numpy as np
import pytest

from p_a_multigrids_tpu.mesh import splitting as jsplit
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.validation import analytical as ja
from p_a_multigrids_tpu.validation import gates as jg
from p_a_multigrids_tpu.validation import probe as jp

from p_a_multigrids_tpu_torch.validation import analytical as ta
from p_a_multigrids_tpu_torch.validation import gates as tg
from p_a_multigrids_tpu_torch.validation import probe as tp

RNG = np.random.default_rng(11)
X = RNG.uniform(0.0, 2.0, size=300)
Y = RNG.uniform(0.0, 1.0, size=300)


@pytest.mark.parametrize("t,gamma", [(0.1, 1.0), (0.02, 1.0), (0.5, 2.5)])
def test_breakthrough_erfc_identical(t, gamma):
    np.testing.assert_array_equal(ta.breakthrough_erfc(X, t, gamma),
                                  ja.breakthrough_erfc(X, t, gamma))


def test_manufactured_and_moving_box_identical():
    np.testing.assert_array_equal(ta.manufactured_sin(X, Y),
                                  ja.manufactured_sin(X, Y))
    xs = RNG.uniform(0.0, 100.0, size=500)
    np.testing.assert_array_equal(ta.moving_box(xs, 250.0, 0.0286, 39, 100),
                                  ja.moving_box(xs, 250.0, 0.0286, 39, 100))


@pytest.mark.parametrize("shift", [0.0, 3e-3, 0.02])
def test_gates_identical(shift):
    expected = np.sin(X)
    computed = expected + shift * RNG.normal(size=X.shape)
    computed[::37] = np.nan                 # probes outside the mesh
    got, want = tg.check(computed, expected), jg.check(computed, expected)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)
    assert tg.TOLERANCE_L1_NORM == jg.TOLERANCE_L1_NORM


def test_probe_identical():
    mesh = jstruct.tri_mesh(12, 3, 2.0 / 12, 0.1 / 3)
    coords = jsplit.child_coords(mesh.X, 0).reshape(-1, 2, 3)
    vals = RNG.normal(size=(coords.shape[0], 3))
    pts = np.stack([RNG.uniform(-0.1, 2.1, 50), RNG.uniform(0, 0.1, 50)], 1)
    np.testing.assert_array_equal(tp.sample_points(coords, vals, pts),
                                  jp.sample_points(coords, vals, pts))
    for got, want in zip(tp.line_probe(coords, vals, 0.0333, 0.0, 1.0),
                         jp.line_probe(coords, vals, 0.0333, 0.0, 1.0)):
        np.testing.assert_array_equal(got, want)

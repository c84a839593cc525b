"""The port's entry step (p_a_multigrids_tpu_torch/entry.py) == the JAX
package's ``__graft_entry__.entry`` step on the same small problem
(float32, CPU, 1e-5)."""

import torch_threads  # noqa: F401

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from p_a_multigrids_tpu_torch import entry as tentry

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry


def test_entry_step_matches_jax():
    jstep, (jT0,) = _jax_entry()()
    tstep, (tT0,) = tentry.entry("cpu")
    assert tT0.dtype == torch.float32 and tT0.device.type == "cpu"
    np.testing.assert_array_equal(tT0.numpy(), np.asarray(jT0))
    want = np.asarray(jstep(jT0))
    got = tstep(tT0).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tentry.entry()


def test_entry_main_prints_shape(capsys):
    tentry.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip() == "(32, 16, 3)"

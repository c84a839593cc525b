"""Mode 1 (rectangular DG advection) on the port == the JAX package's,
float64 on the CPU: the host copies (rect_mesh, gauss_01, quad_bilinear,
quad_det_nlx, det_snlx, write_curve) equal the JAX functions, steps equal
the JAX steps to 1e-12, and the moving-box and Jacobi-equals-direct gates
of tests/test_transport.py pass on the port."""

import torch_threads  # noqa: F401

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.io import curves as jcurves
from p_a_multigrids_tpu.mesh import geometry as jgeo
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import transport_rect as jrect
from p_a_multigrids_tpu.utils import quadrature as jquad
from p_a_multigrids_tpu.utils import shape_functions as jshape

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch import convert
from p_a_multigrids_tpu_torch.io import curves as tcurves
from p_a_multigrids_tpu_torch.mesh import geometry as tgeo
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.models import transport_rect as trect
from p_a_multigrids_tpu_torch.utils import quadrature as tquad
from p_a_multigrids_tpu_torch.utils import shape_functions as tshape


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("shape", [(5, 1, 0.5, 1.0), (4, 3, 0.25, 1 / 3)])
def test_rect_mesh_and_quad_tables(shape):
    for a, b in zip(jstruct.rect_mesh(*shape), tstruct.rect_mesh(*shape)):
        assert_same(a, b, "rect_mesh")
    for n in (1, 2, 3):
        for a, b in zip(jquad.gauss_01(n), tquad.gauss_01(n)):
            assert_same(a, b, f"gauss_01({n})")
    jq, tq = jshape.quad_bilinear(2), tshape.quad_bilinear(2)
    for a, b in zip(jq[:3], tq[:3]):
        assert_same(a, b, "quad_bilinear")
    assert set(jq[3]) == set(tq[3])
    for key in jq[3]:
        assert_same(jq[3][key], tq[3][key], f"quad face table {key}")


@pytest.mark.parametrize("shape", [(5, 1, 0.5, 1.0), (4, 3, 0.25, 1 / 3)])
def test_quad_geometry_matches_jax(shape):
    """quad_det_nlx and det_snlx (jax functions there, numpy here) at
    float64 rounding."""
    x_all, _ = tstruct.rect_mesh(*shape)
    n, nlx, w, ft = tshape.quad_bilinear(2)
    for a, b in zip(jgeo.quad_det_nlx(jnp.asarray(x_all), jnp.asarray(nlx),
                                      jnp.asarray(w)),
                    tgeo.quad_det_nlx(x_all, nlx, w)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-14, atol=1e-14)
    _, snlx, sw = tshape.edge_p1(2)
    centroid = x_all.mean(axis=2)
    for f, (a, b) in enumerate(ft["face_nodes"]):
        xsl = x_all[:, :, [a, b]]
        approx = xsl.mean(axis=2) - centroid
        want = jgeo.det_snlx(jnp.asarray(xsl), jnp.asarray(snlx),
                             jnp.asarray(sw), jnp.asarray(approx))
        got = tgeo.det_snlx(xsl, snlx, sw, approx)
        for g, h in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(h), rtol=1e-14,
                                       atol=1e-14)


CASES = {
    "jacobi_row": dict(no_ele_row=40, no_ele_col=1, time=20.0),
    "jacobi_2d": dict(no_ele_row=20, no_ele_col=3, time=40.0,
                      u=(0.05, 0.0)),
    "direct": dict(no_ele_row=40, no_ele_col=1, time=20.0,
                   direct_solver=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_jax(case):
    jc = jcfg.RectConfig(dtype="float64", **CASES[case])
    tc = tcfg.RectConfig(dtype="float64", **CASES[case])
    jp, jT, jdt, jn = jrect.solve(jc)
    tp, tT, tdt, tn = trect.solve(tc, device="cpu")
    assert (tdt, tn) == (jdt, jn) and tn > 5
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(
        trect.analytical_comparison(tp, tdt, tn),
        jrect.analytical_comparison(jp, jdt, jn))


def test_step_from_jax_tables_matches_jax():
    """The port's step on the JAX problem's own tables
    (convert.rect_from_numpy) == the JAX step, from a random state."""
    kw = CASES["jacobi_2d"]
    jp = jrect.build_problem(jcfg.RectConfig(dtype="float64", **kw))
    tc = tcfg.RectConfig(dtype="float64", **kw)
    tp = convert.rect_from_numpy(tc, jp.x_all, jp.face_ele, jp.tables, "cpu")
    T = np.random.default_rng(0).normal(size=(jp.x_all.shape[0], 4))
    jstep, _ = jrect.make_step(jp)
    tstep, _ = trect.make_step(tp)
    np.testing.assert_allclose(tstep(torch.tensor(T)).numpy(),
                               np.asarray(jstep(jnp.asarray(T))),
                               rtol=1e-12, atol=1e-12)
    own = trect.build_problem(tc, device="cpu")
    for key in trect.TABLE_KEYS:
        np.testing.assert_allclose(own.tables[key].numpy(),
                                   tp.tables[key].numpy(), rtol=1e-13,
                                   atol=1e-13, err_msg=key)


def test_rect_moving_box():
    """The advected box's centre of mass shifts by u*t and the mass is
    conserved (tests/test_transport.py:95-110)."""
    cfg = tcfg.RectConfig(no_ele_row=100, no_ele_col=1, time=250.0,
                          u=(2 * 0.01428571, 0.0), direct_solver=True,
                          dtype="float64")
    problem, T, dt, ntime = trect.solve(cfg, device="cpu")
    T = T.numpy()
    xs = problem.x_all[:, 0, :]
    com = (xs * T).sum() / T.sum()
    lo = (cfg.no_ele_row // 5 - 1) * 1.0
    hi = cfg.no_ele_row // 2 * 1.0
    com_expected = 0.5 * (lo + hi) + cfg.u[0] * dt * ntime
    assert abs(com - com_expected) < 1e-6
    assert np.isclose(T.sum(), (hi - lo) * 4, rtol=1e-10)


def test_rect_jacobi_matches_direct():
    cfg_d = tcfg.RectConfig(no_ele_row=40, no_ele_col=1, time=20.0,
                            u=(0.05, 0.0), direct_solver=True,
                            dtype="float64")
    cfg_j = dataclasses.replace(cfg_d, direct_solver=False, njac_its=50)
    _, Td, _, _ = trect.solve(cfg_d, device="cpu")
    _, Tj, _, _ = trect.solve(cfg_j, device="cpu")
    assert np.allclose(Td.numpy(), Tj.numpy(), atol=1e-6)


def test_initial_box_paints_the_bottom_row():
    """With cols > 1 the box paints elements lo-1:hi by flat index: the
    bottom row of cells only, as in the JAX package."""
    cfg = tcfg.RectConfig(no_ele_row=10, no_ele_col=3, dtype="float64")
    T0 = trect.initial_condition(trect.build_problem(cfg, device="cpu")
                                 ).numpy()
    assert T0[:10].sum() == (10 // 2 - 10 // 5 + 1) * 4
    assert T0[10:].sum() == 0.0


def test_write_curve_matches_jax(tmp_path):
    x_all, _ = tstruct.rect_mesh(4, 2, 0.5, 1.0)
    vals = np.random.default_rng(1).normal(size=(8, 4))
    for two_d in (False, True):
        jcurves.write_curve(str(tmp_path / "j"), x_all, vals, two_d)
        tcurves.write_curve(str(tmp_path / "t"), x_all, vals, two_d)
        assert ((tmp_path / "t").read_text()
                == (tmp_path / "j").read_text())

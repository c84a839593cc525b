"""The port's smoothed-aggregation (SA) hierarchy == the JAX package's.

Host half: ``build_hierarchy`` gives the same tables bit for bit.  Device
half, float64 on the CPU: ``rowop_reference`` (the plain version of kernel
K2) matches the JAX einsum gather and the JAX Pallas SpMV in interpret mode
at 1e-12, and the SA V-cycle, the correction and the tentative transfers
match JAX at 1e-12 on the same hierarchy.
"""

import torch_threads  # noqa: F401

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import splitting as jsplit
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.mesh import topology as jtopo
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.ops import agg as jagg
from p_a_multigrids_tpu.ops import stencil as jstencil

from p_a_multigrids_tpu_torch import convert
from p_a_multigrids_tpu_torch.ops import agg as tagg
from p_a_multigrids_tpu_torch.ops import spmv
from p_a_multigrids_tpu_torch.ops.stencil import StencilData

TOL = dict(rtol=1e-12, atol=1e-12)


def _level0(n_split, dtype="float64"):
    """(JAX StencilData, port StencilData, coords) of the finest level of
    an RCM-ordered 8 x 8 mesh."""
    mesh = jtopo.rcm_reorder(jstruct.tri_mesh(8, 8, 0.125, 0.125))
    cfg = jcfg.SemiConfig(n_split=n_split, multi_levels=1, dt=0.05,
                          dtype=dtype)
    L = jsemi.build_problem(mesh, cfg).levels[0]
    jd = jstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    td = StencilData(**{f.name: getattr(jd, f.name)
                        for f in dataclasses.fields(StencilData)})
    return jd, td, jsplit.child_coords(mesh.X, n_split)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


# (strength, always, n_split, max_dense_dof): several levels; one forced
# level on a system below the dense cap; none (always=False below the cap)
BUILDS = {
    "s0_multi": (0.0, False, 2, 256),
    "s05_multi": (0.5, False, 2, 256),
    "s0_always": (0.0, True, 1, 4096),
    "s05_always": (0.5, True, 2, 1024),
    "s05_below_cap": (0.5, False, 1, 4096),
}


@pytest.mark.parametrize("case", list(BUILDS))
def test_build_hierarchy_bit_identical(case):
    strength, always, n_split, max_dense = BUILDS[case]
    jd, td, coords = _level0(n_split)
    kw = dict(max_dense_dof=max_dense, omega=0.8, sweeps=2,
              dtype=np.float64, strength=strength, always=always)
    jh = jagg.build_hierarchy(jd, coords, **kw)
    th = tagg.build_hierarchy(td, coords, **kw)
    assert len(th.levels) == len(jh.levels)
    assert (len(th.levels) == 0) == (case == "s05_below_cap")
    if case.endswith("multi"):
        assert len(th.levels) >= 2
    for k, (jl, tl) in enumerate(zip(jh.levels, th.levels)):
        for f in dataclasses.fields(tagg.HostLevel):
            if f.name in ("n", "omega"):
                assert getattr(tl, f.name) == getattr(jl, f.name)
            else:
                _same(getattr(jl, f.name), getattr(tl, f.name),
                      f"level {k} {f.name}")
    for name in ("coarse_inv", "coarse_scale"):
        j, t = getattr(jh, name), getattr(th, name)
        assert (j is None) == (t is None)
        if j is not None:
            _same(j, t, name)
    assert (th.omega, th.sweeps) == (jh.omega, jh.sweeps)
    assert (th.fine is None) == (jh.fine is None)
    if th.fine is not None:
        assert th.fine["w"] == jh.fine["w"]
        for key in ("dinv_t", "r_cols", "r_vals", "p_cols", "p_vals"):
            _same(jh.fine[key], th.fine[key], f"fine {key}")


def test_build_hierarchy_float32_tables():
    """In f32 the tables are cast as the JAX package casts them."""
    jd, td, coords = _level0(2, "float32")
    kw = dict(max_dense_dof=1024, dtype=np.float32, strength=0.5)
    jh = jagg.build_hierarchy(jd, coords, **kw)
    th = tagg.build_hierarchy(td, coords, **kw)
    for jl, tl in zip(jh.levels, th.levels):
        for name in ("cols", "vals", "dinv", "r_vals", "p_cols"):
            _same(getattr(jl, name), getattr(tl, name), name)
    _same(jh.coarse_inv, th.coarse_inv, "coarse_inv")


def test_packed_stencil_raises():
    """A macro-packed level does not follow the splitting lattice: the
    port's SA builder refuses it instead of building a wrong matrix."""
    jd, _, _ = _level0(1)
    packed = jstencil.pack_stencil(jd, 4)
    assert packed.slot_mf is not None
    td = StencilData(**{f.name: getattr(packed, f.name)
                        for f in dataclasses.fields(StencilData)})
    with pytest.raises(ValueError, match="macro-packed"):
        tagg._csr_from_stencil(td)


def _banded_rows(n_out, n_src, D, seed=0):
    """Random block rows with banded columns (the JAX kernel's RCM
    assumption), as tests/test_agg.py makes them."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_src, size=(n_out, D))
    vals = rng.normal(size=(n_out, D, 3, 3))
    rows = np.arange(n_out)[:, None] * n_src // n_out
    return np.clip(rows + (cols % 17) - 8, 0, n_src - 1), vals


@pytest.mark.parametrize("variant", ["thread", "lanes"])
@pytest.mark.parametrize("shape", [(96, 96), (48, 96), (96, 48)])
def test_rowop_reference_matches_jax(shape, variant):
    """Each K2 layout (D = 5 slots; "lanes" pads them to 8) read by the plain
    version equals the JAX einsum gather and Pallas SpMV."""
    n_out, n_src = shape
    cols, vals = _banded_rows(n_out, n_src, D=5)
    x = np.random.default_rng(1).normal(size=(3, n_src))
    op = spmv.RowOp(cols, vals, n_src, torch.float64, "cpu", variant)
    assert op.variant == variant
    assert op.vals_t.shape == ((5, 3, 3, n_out) if variant == "thread"
                               else (n_out, 3, 3, 8))
    got = op(torch.tensor(x)).numpy()
    einsum = np.asarray(jagg._rowop_einsum_t(jnp.asarray(cols),
                                             jnp.asarray(vals),
                                             jnp.asarray(x)))
    pallas = np.asarray(jagg._mk_rowop(cols, vals, n_out, n_src, np.float64,
                                       interpret=True)(jnp.asarray(x)))
    np.testing.assert_allclose(got, einsum, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    assert spmv.KERNEL.launches == 0         # CPU tensors never launch K2


def test_rowop_checks_its_input():
    cols, vals = _banded_rows(8, 6, D=3)
    op = spmv.RowOp(cols, vals, 6, torch.float64, "cpu")
    with pytest.raises(ValueError, match="shape"):
        op(torch.zeros((3, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        op(torch.zeros((6, 3), dtype=torch.float64).T)
    with pytest.raises(ValueError, match="float32"):
        op(torch.zeros((3, 6), dtype=torch.float32))
    with pytest.raises(ValueError, match="column index"):
        spmv.RowOp(cols, vals, int(cols.max()), torch.float64, "cpu")
    with pytest.raises(ValueError, match="vals shape"):
        spmv.RowOp(cols, vals[:, :2], 6, torch.float64, "cpu")


@pytest.fixture(scope="module")
def hierarchies():
    """(JAX hierarchy, port AggHierarchy from the port's own builder) with
    three SA levels and a dense bottom, float64."""
    jd, td, coords = _level0(2)
    kw = dict(max_dense_dof=256, dtype=np.float64, strength=0.4,
              always=True)
    jh = jagg.build_hierarchy(jd, coords, **kw)
    th = tagg.AggHierarchy(tagg.build_hierarchy(td, coords, **kw),
                           torch.float64, "cpu")
    assert len(jh.levels) >= 3 and jh.coarse_inv is not None
    return jh, th


def _rand(n, seed):
    return np.random.default_rng(seed).normal(size=(3, n))


@pytest.mark.parametrize("ncycles", [1, 2])
def test_vcycle_matches_jax(hierarchies, ncycles):
    jh, th = hierarchies
    b = _rand(jh.levels[0].n, 5)
    want = np.asarray(jagg.vcycle_iter(jh, jnp.asarray(b), ncycles))
    got = tagg.vcycle_iter(th, torch.tensor(b), ncycles).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # one level down: the recursion below level 0
    b1 = _rand(jh.levels[1].n, 6)
    np.testing.assert_allclose(tagg.vcycle(th, 1, torch.tensor(b1)).numpy(),
                               np.asarray(jagg.vcycle(jh, 1,
                                                      jnp.asarray(b1))),
                               **TOL)


def test_correct_t_matches_jax(hierarchies):
    jh, th = hierarchies
    E = jh.levels[0].p_cols.shape[0]
    r = _rand(E, 7)
    want = np.asarray(jagg.correct_t(jh, jnp.asarray(r), 2))
    got = tagg.correct_t(th, torch.tensor(r), 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_tent_transfers_match_jax(hierarchies):
    jh, th = hierarchies
    E, na = jh.levels[0].p_cols.shape[0], jh.levels[0].n
    y, e = _rand(E, 8), _rand(na, 9)
    np.testing.assert_allclose(
        th.tent_r(torch.tensor(y)).numpy(),
        np.asarray(jagg.tent_restrict(jh, jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(
        th.tent_p(torch.tensor(e)).numpy(),
        np.asarray(jagg.tent_prolong(jh, jnp.asarray(e))), **TOL)


def test_converted_hierarchy_equals_own(hierarchies):
    """``convert.agg_from_numpy`` of the JAX hierarchy moves over the same
    tables the port builds itself."""
    jh, th = hierarchies
    conv = tagg.AggHierarchy(convert.agg_from_numpy(jh), torch.float64,
                             "cpu")
    own, moved = th.state_dict(), conv.state_dict()
    assert own.keys() == moved.keys()
    for key in own:
        assert torch.equal(own[key], moved[key]), key
    assert ([lv.omega for lv in conv.levels]
            == [lv.omega for lv in th.levels])
    assert conv.w == th.w
    names = set(th.rowops())
    assert {"l0_op", "l0_r", "l0_p", "fine_tent_r", "fine_tent_p"} <= names
    assert len(names) == 3 * len(th.levels) + 2

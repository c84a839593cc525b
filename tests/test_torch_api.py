"""The rest of the JAX package's public functions in the port, each held to
its JAX counterpart on the same seeded inputs in float64 on the CPU: the
natural-layout gathers and transfers, ``SemiSolver.solve_system`` (PCG and
BiCGStab, the same iteration counts), the SA wrappers, ``BSR``'s methods,
``block_jacobi``, the stencil's smoothing methods, the local matrices, the
geometry, ``tet_rule`` and ``load_committed``."""

import torch_threads  # noqa: F401

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import geometry as jgeom
from p_a_multigrids_tpu.mesh import splitting as jsplit
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.mesh import topology as jtopo
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.ops import agg as jagg
from p_a_multigrids_tpu.ops import bsr as jbsr
from p_a_multigrids_tpu.ops import krylov as jkrylov
from p_a_multigrids_tpu.ops import local_matrices as jlm
from p_a_multigrids_tpu.ops import smoothers as jsmoothers
from p_a_multigrids_tpu.ops import stencil as jstencil
from p_a_multigrids_tpu.utils import quadrature as jquad
from p_a_multigrids_tpu.validation import history as jhistory

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch.mesh import geometry as tgeom
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.models import semi as tsemi
from p_a_multigrids_tpu_torch.ops import agg as tagg
from p_a_multigrids_tpu_torch.ops import bsr as tbsr
from p_a_multigrids_tpu_torch.ops import local_matrices as tlm
from p_a_multigrids_tpu_torch.ops import smoothers as tsmoothers
from p_a_multigrids_tpu_torch.ops import spmv
from p_a_multigrids_tpu_torch.ops import stencil as tstencil
from p_a_multigrids_tpu_torch.utils import quadrature as tquad
from p_a_multigrids_tpu_torch.validation import history as thistory

TOL = dict(rtol=1e-12, atol=1e-12)
SOLVE_TOL = dict(rtol=1e-9, atol=1e-9)


def _rng(seed):
    return np.random.default_rng(seed)


# -- models/semi.py: the natural-layout gathers and transfers --------------

@pytest.mark.parametrize("n_split", [1, 2])
def test_structured_gather_matches_jax(n_split):
    cfg = jcfg.SemiConfig(n_split=n_split, multi_levels=1, dt=0.05,
                          dtype="float64")
    mesh = jstruct.tri_mesh(5, 3, 0.2, 1 / 3)
    jL = jsemi.build_problem(mesh, cfg).levels[0]
    tL = tsemi.level_tensors(tsemi.build_problem(
        tstruct.tri_mesh(5, 3, 0.2, 1 / 3),
        tcfg.SemiConfig(n_split=n_split, multi_levels=1, dt=0.05,
                        dtype="float64")).levels[0], "cpu")
    X = _rng(0).normal(size=(mesh.num_elements, 4 ** n_split, 3))
    want = np.asarray(jsemi.structured_gather(jL, jnp.asarray(X)))
    got = tsemi.structured_gather(tL, torch.tensor(X)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_coarse", [0, 1, 2])
def test_transfers_match_jax(n_coarse):
    U, Cc, Cf = 7, 4 ** n_coarse, 4 ** (n_coarse + 1)
    r = _rng(n_coarse).normal(size=(U, Cf, 3))
    e = _rng(10 + n_coarse).normal(size=(U, Cc, 3))
    for name, x in (("restrict", r), ("restrict_corner_average", r),
                    ("prolong", e)):
        want = np.asarray(getattr(jsemi, name)(jnp.asarray(x), n_coarse))
        got = getattr(tsemi, name)(torch.tensor(x), n_coarse).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


# -- SemiSolver.solve_system ------------------------------------------------

def _pair(advect: bool, **kw):
    u = (0.4, -0.2) if advect else (0.0, 0.0)
    kw = dict(dict(n_split=2, multi_levels=2, dt=0.05, ntime=1,
                   dtype="float64", krylov=True, krylov_tol=1e-8), **kw)
    jc = jcfg.SemiConfig(pallas_phase=False, physics=jcfg.Physics(
        advection=advect, u=u), **kw)
    tc = tcfg.SemiConfig(physics=tcfg.Physics(advection=advect, u=u), **kw)
    js = jsemi.SemiSolver(jsemi.build_problem(
        jstruct.tri_mesh(4, 4, 0.25, 0.25), jc))
    ts = tsemi.SemiSolver(tsemi.build_problem(
        tstruct.tri_mesh(4, 4, 0.25, 0.25), tc), "cpu")
    return js, ts


@pytest.mark.parametrize("case", ["pcg", "bicgstab", "amg_pcg"])
def test_solve_system_matches_jax(case):
    """solve_system(b, x0) in the natural layout: the JAX package's
    solution (1e-9) in its iteration count (the count from the Krylov call
    its solve_system makes)."""
    advect = case == "bicgstab"
    kw = (dict(multi_levels=1, amg=True, agg_strength=0.5,
               agg_dense_max_dof=128) if case == "amg_pcg" else {})
    js, ts = _pair(advect, **kw)
    U, C = js.p.num_macro, js.p.levels[0]["C"]
    rng = _rng(3)
    b, x0 = rng.normal(size=(U, C, 3)), rng.normal(size=(U, C, 3))
    want = np.asarray(js.solve_system(jnp.asarray(b), jnp.asarray(x0)))
    c = js._apply(0, jnp.zeros_like(jnp.asarray(b)), True)
    method = jkrylov.bicgstab if advect else jkrylov.pcg
    _, it_j, _ = method(
        lambda x: js._apply(0, x, False), jnp.asarray(b) - c,
        jnp.asarray(x0),
        precond=lambda r: js._vcycle(0, jnp.zeros_like(r), r, hom=True),
        tol=js.cfg.krylov_tol, maxiter=js.cfg.krylov_maxiter)
    got = ts.solve_system(torch.tensor(b), torch.tensor(x0))
    assert got.shape == (U, C, 3)
    np.testing.assert_allclose(got.numpy(), want, **SOLVE_TOL)
    assert ts.krylov_iters == [int(it_j)]
    assert 1 < int(it_j) < js.cfg.krylov_maxiter


# -- ops/agg.py --------------------------------------------------------------

@pytest.fixture(scope="module")
def hierarchies():
    """(JAX hierarchy, port AggHierarchy) with factored fine transfers,
    several SA levels and a dense bottom, float64."""
    mesh = jtopo.rcm_reorder(jstruct.tri_mesh(8, 8, 0.125, 0.125))
    cfg = jcfg.SemiConfig(n_split=2, multi_levels=1, dt=0.05,
                          dtype="float64")
    L = jsemi.build_problem(mesh, cfg).levels[0]
    jd = jstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    td = tstencil.StencilData(**{f.name: getattr(jd, f.name) for f in
                                 dataclasses.fields(tstencil.StencilData)})
    coords = jsplit.child_coords(mesh.X, 2)
    kw = dict(max_dense_dof=256, dtype=np.float64, strength=0.4,
              always=True)
    jh = jagg.build_hierarchy(jd, coords, **kw)
    th = tagg.AggHierarchy(tagg.build_hierarchy(td, coords, **kw),
                           torch.float64, "cpu")
    assert jh.fine is not None and th.tent_r is not None
    return jh, th


def test_tent_transfers_match_jax(hierarchies):
    jh, th = hierarchies
    E, na = jh.levels[0].p_cols.shape[0], jh.levels[0].n
    y, e = _rng(8).normal(size=(3, E)), _rng(9).normal(size=(3, na))
    np.testing.assert_allclose(
        tagg.tent_restrict(th, torch.tensor(y)).numpy(),
        np.asarray(jagg.tent_restrict(jh, jnp.asarray(y))), **TOL)
    np.testing.assert_allclose(
        tagg.tent_prolong(th, torch.tensor(e)).numpy(),
        np.asarray(jagg.tent_prolong(jh, jnp.asarray(e))), **TOL)


def test_tent_transfers_need_factored_transfers(hierarchies):
    _, th = hierarchies
    tent_r, tent_p = th.tent_r, th.tent_p
    th.tent_r = th.tent_p = None
    try:
        with pytest.raises(ValueError, match="factored"):
            tagg.tent_restrict(th, torch.zeros(3, 4, dtype=torch.float64))
        with pytest.raises(ValueError, match="factored"):
            tagg.tent_prolong(th, torch.zeros(3, 4, dtype=torch.float64))
    finally:
        th.tent_r, th.tent_p = tent_r, tent_p


@pytest.mark.parametrize("ncycles", [1, 2])
def test_correct_matches_jax(hierarchies, ncycles):
    jh, th = hierarchies
    E = jh.levels[0].p_cols.shape[0]
    r = _rng(7).normal(size=(E, 3))
    want = np.asarray(jagg.correct(jh, jnp.asarray(r), ncycles))
    got = tagg.correct(th, torch.tensor(r), ncycles)
    assert got.shape == (E, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, **SOLVE_TOL)


# -- ops/bsr.py ---------------------------------------------------------------

def test_bsr_methods_match_jax():
    E, nface = 40, 3
    rng = _rng(11)
    neigh = np.where(rng.random((E, nface)) < 0.2, -1,
                     rng.integers(0, E, (E, nface)))
    diag = rng.normal(size=(E, 3, 3))
    faces = rng.normal(size=(E, nface, 3, 3))
    got = tbsr.build(diag, faces, neigh)
    want = jbsr.build(jnp.asarray(diag), jnp.asarray(faces), neigh)
    assert got.block_size == want.block_size == 3
    x = rng.normal(size=(E, 3))
    n0 = spmv.KERNEL.launches
    y = got.spmv(torch.tensor(x))
    assert y.shape == (E, 3)
    np.testing.assert_allclose(y.numpy(), np.asarray(want.spmv(
        jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(got.diag_blocks(),
                               np.asarray(want.diag_blocks()), **TOL)
    np.testing.assert_allclose(got.diagonal(), np.asarray(want.diagonal()),
                               **TOL)
    assert spmv.KERNEL.launches == n0       # CPU tensors never launch K2


def test_bsr_to_dense_matches_jax():
    """``BSR.to_dense`` adds the same blocks into the same places as the
    JAX method's scatter-add, in ``vals``' dtype."""
    E, nface = 40, 3
    rng = _rng(13)
    neigh = np.where(rng.random((E, nface)) < 0.2, -1,
                     rng.integers(0, E, (E, nface)))
    diag = rng.normal(size=(E, 3, 3))
    faces = rng.normal(size=(E, nface, 3, 3))
    got = tbsr.build(diag, faces, neigh).to_dense(device="cpu")
    want = np.asarray(jbsr.build(jnp.asarray(diag), jnp.asarray(faces),
                                 neigh).to_dense())
    assert got.dtype == torch.float64 and got.shape == (3 * E, 3 * E)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


# -- ops/smoothers.py ---------------------------------------------------------

@pytest.mark.parametrize("omega,sweeps", [(1.0, 1), (0.7, 3)])
def test_block_jacobi_matches_jax(omega, sweeps):
    n = 6
    rng = _rng(5)
    A = rng.normal(size=(3 * n, 3 * n)) + 12 * np.eye(3 * n)
    blocks = np.stack([A[3 * i:3 * i + 3, 3 * i:3 * i + 3]
                       for i in range(n)])
    b, x = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    want = jsmoothers.block_jacobi(
        lambda v: (jnp.asarray(A) @ v.reshape(-1)).reshape(n, 3),
        jnp.asarray(b), jnp.asarray(x), jnp.asarray(blocks), omega, sweeps)
    At = torch.tensor(A)
    got = tsmoothers.block_jacobi(
        lambda v: (At @ v.reshape(-1)).reshape(n, 3), torch.tensor(b),
        torch.tensor(x), torch.tensor(blocks), omega, sweeps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("omega", [0.7, 1.0])
def test_block_jacobi_inv_matches_jax(omega, sweeps):
    """Block Jacobi over pre-inverted blocks, the same dense apply_A."""
    n = 6
    rng = _rng(9)
    A = rng.normal(size=(3 * n, 3 * n)) + 12 * np.eye(3 * n)
    inv = np.linalg.inv(np.stack([A[3 * i:3 * i + 3, 3 * i:3 * i + 3]
                                  for i in range(n)]))
    b, x = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    want = jsmoothers.block_jacobi_inv(
        lambda v: (jnp.asarray(A) @ v.reshape(-1)).reshape(n, 3),
        jnp.asarray(b), jnp.asarray(x), jnp.asarray(inv), omega, sweeps)
    At = torch.tensor(A)
    got = tsmoothers.block_jacobi_inv(
        lambda v: (At @ v.reshape(-1)).reshape(n, 3), torch.tensor(b),
        torch.tensor(x), torch.tensor(inv), omega, sweeps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


# -- ops/stencil.py -----------------------------------------------------------

def _stencil_ops(advection: bool, n_split: int = 2):
    phys = jcfg.Physics(advection=advection,
                        u=(0.4, -0.2) if advection else (0.0, 0.0))
    cfg = jcfg.SemiConfig(n_split=n_split, multi_levels=1, dt=0.05,
                          dtype="float64", physics=phys)
    L = jsemi.build_problem(jstruct.tri_mesh(6, 3, 0.3, 0.2), cfg).levels[0]
    data = jstencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
    return (jstencil.StencilOperator(data, np.float64),
            tstencil.StencilOperator(tstencil.StencilData(**vars(data)),
                                     torch.float64, "cpu"))


@pytest.mark.parametrize("advection", [False, True])
@pytest.mark.parametrize("n_split", [1, 2])
def test_stencil_lam_max_matches_jax(n_split, advection):
    jop, top = _stencil_ops(advection, n_split)
    want = jop.lam_max_estimate()
    assert top.lam_max_estimate() == pytest.approx(want, rel=1e-12)
    assert top.lam_max_estimate(5, 3) == pytest.approx(
        jop.lam_max_estimate(5, 3), rel=1e-12)


@pytest.mark.parametrize("with_bc", [False, True])
@pytest.mark.parametrize("advection", [False, True])
def test_stencil_smoothing_matches_jax(advection, with_bc):
    jop, top = _stencil_ops(advection)
    rng = _rng(2)
    x = rng.normal(size=(3, jop.C, jop.U))
    b = rng.normal(size=(3, jop.C, jop.U))
    roots = [1.9, 0.4, 1.2]
    want = np.asarray(jop.smooth_chebyshev(jnp.asarray(x), jnp.asarray(b),
                                           roots, 2, with_bc))
    got = top.smooth_chebyshev(torch.tensor(x), torch.tensor(b), roots, 2,
                               with_bc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want = np.asarray(jop.smooth_jacobi(jnp.asarray(x), jnp.asarray(b), 0.6,
                                        3, with_bc))
    got = top.smooth_jacobi(torch.tensor(x), torch.tensor(b), 0.6, 3,
                            with_bc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- ops/local_matrices.py, mesh/geometry.py, utils/quadrature.py -----------

def test_face_penalty_and_upwind_flux_match_jax():
    rng = _rng(4)
    E, nface, sngi, nloc = 5, 3, 2, 3
    face_sn = rng.normal(size=(nface, sngi, nloc))
    sdetwei = rng.random((E, nface, sngi))
    k_over_dx = rng.random((E, nface))
    np.testing.assert_allclose(
        tlm.face_penalty(face_sn, sdetwei, k_over_dx),
        jlm.face_penalty(face_sn, sdetwei, k_over_dx), **TOL)
    args = (face_sn, face_sn, sdetwei,
            rng.normal(size=(E, nface, sngi, 2)),
            rng.normal(size=(E, nface, sngi, 2)),
            rng.normal(size=(E, nface, sngi, 2)),
            rng.normal(size=(E, nface, sngi)),
            rng.normal(size=(E, nface, sngi)))
    np.testing.assert_allclose(tlm.upwind_face_flux(*args),
                               jlm.upwind_face_flux(*args), **TOL)


def test_geometry_matches_jax():
    rng = _rng(6)
    L, w = tquad.triangle_rule(3)
    nlx = np.stack([np.broadcast_to([1.0, 0.0, -1.0], (3, 3)),
                    np.broadcast_to([0.0, 1.0, -1.0], (3, 3))], axis=1)
    x_loc = rng.normal(size=(7, 2, 3))
    got = tgeom.tri_det_nlx(x_loc, nlx, w)
    want = jgeom.tri_det_nlx(jnp.asarray(x_loc), jnp.asarray(nlx),
                             jnp.asarray(w))
    for g, v, name in zip(got, want, ("detwei", "nx", "inv_jac")):
        np.testing.assert_allclose(g, np.asarray(v), **TOL, err_msg=name)
    detwei, nx, _ = got
    sdet = rng.random((7, 3, 2))
    for sd in (sdet, None):
        gl = tgeom.semi_level_scalings(detwei, nx, sd, 3, 2)
        wl = jgeom.semi_level_scalings(detwei, nx, sd, 3, 2)
        assert len(gl) == len(wl) == 2
        for g, v in zip(gl, wl):
            assert g.keys() == v.keys()
            for key in g:
                if v[key] is None:
                    assert g[key] is None
                else:
                    np.testing.assert_allclose(g[key], v[key], **TOL)


@pytest.mark.parametrize("ngi", [1, 4, 5, 11])
def test_tet_rule_matches_jax(ngi):
    L, w = tquad.tet_rule(ngi)
    jL, jw = jquad.tet_rule(ngi)
    np.testing.assert_allclose(L, jL, **TOL)
    np.testing.assert_allclose(w, jw, **TOL)
    assert w.sum() == pytest.approx(1 / 6, rel=1e-12)


def test_tet_rule_rejects_unknown_size():
    with pytest.raises(ValueError, match="ngi=2"):
        tquad.tet_rule(2)


# -- validation/history.py ------------------------------------------------------

def test_load_committed_matches_jax(tmp_path):
    assert thistory.load_committed() == jhistory.load_committed()
    path = tmp_path / "h.json"
    path.write_text('{"a": [1.0, 0.5]}')
    assert thistory.load_committed(str(path)) == {"a": [1.0, 0.5]}

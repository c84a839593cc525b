"""Host setup of the PyTorch port == the JAX package's, array for array.

The port carries its own copies of the numpy setup modules (the JAX
package's ``__init__`` imports jax).  Every table they produce must be
bit-identical to the JAX package's in the run dtype, so that the port's
device code starts from the reference's exact coefficients.
"""

import torch_threads  # noqa: F401

import dataclasses

import numpy as np
import pytest

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import semi as jmesh_semi
from p_a_multigrids_tpu.mesh import splitting as jsplit
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.mesh import topology as jtopo
from p_a_multigrids_tpu.models import semi as jsemi
from p_a_multigrids_tpu.ops import smoothers as jsmooth
from p_a_multigrids_tpu.ops import stencil as jstencil

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch.mesh import semi as tmesh_semi
from p_a_multigrids_tpu_torch.mesh import splitting as tsplit
from p_a_multigrids_tpu_torch.mesh import structured as tstruct
from p_a_multigrids_tpu_torch.mesh import topology as ttopo
from p_a_multigrids_tpu_torch.models import semi as tsemi
from p_a_multigrids_tpu_torch.ops import smoothers as tsmooth
from p_a_multigrids_tpu_torch.ops import stencil as tstencil

MESHES = [(4, 4, 0.25, 0.25), (6, 3, 0.3, 0.2)]


def assert_same(a, b, what=""):
    """Bit-identical arrays of the same dtype."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def configs(n_split, dtype, advection, levels=None):
    kw = dict(n_split=n_split, multi_levels=levels or n_split + 1, dt=0.05,
              dtype=dtype)
    phys = dict(advection=advection, u=(0.4, -0.2) if advection else (0, 0))
    return (jcfg.SemiConfig(physics=jcfg.Physics(**phys), **kw),
            tcfg.SemiConfig(physics=tcfg.Physics(**phys), **kw))


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_splitting_tables(n):
    for name in ("child_lattice", "child_neighbors",
                 "child_neighbor_nodeperm", "boundary_strips"):
        ja, ta = getattr(jsplit, name)(n), getattr(tsplit, name)(n)
        ja = ja if isinstance(ja, tuple) else (ja,)
        ta = ta if isinstance(ta, tuple) else (ta,)
        for a, b in zip(ja, ta):
            assert_same(a, b, f"{name}({n})")
    if n < 3:
        assert_same(jsplit.element_conversion(n),
                    tsplit.element_conversion(n))
        for a, b in zip(jsemi._transfer_tables(n),
                        tsemi._transfer_tables(n)):
            assert_same(a, b, f"_transfer_tables({n})")
    for name in ("CHILD_FACE_NODES", "MACRO_FACE_NODES", "CHILD2MACRO_FACE"):
        assert_same(getattr(jsplit, name), getattr(tsplit, name), name)


@pytest.mark.parametrize("shape", MESHES)
def test_tri_mesh_and_grid(shape):
    jm, tm = jstruct.tri_mesh(*shape), tstruct.tri_mesh(*shape)
    for f in dataclasses.fields(jtopo.MacroMesh):
        assert_same(getattr(jm, f.name), getattr(tm, f.name), f.name)
    assert_same(jsplit.child_coords(jm.X, 2), tsplit.child_coords(tm.X, 2))
    assert_same(jtopo.rcm_order(jm), ttopo.rcm_order(tm))
    jg, tg = jmesh_semi.build_grid(jm, 3, 4), tmesh_semi.build_grid(tm, 3, 4)
    for jl, tl in zip(jg.levels, tg.levels):
        for f in dataclasses.fields(jmesh_semi.SemiLevel):
            assert_same(getattr(jl, f.name), getattr(tl, f.name), f.name)


@pytest.mark.parametrize("advection", [False, True])
@pytest.mark.parametrize("n_split", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_problem_stencil_and_spectrum(dtype, n_split, advection):
    """build_problem tables, every StencilData field, lam_max, roots."""
    jc, tc = configs(n_split, dtype, advection)
    jp = jsemi.build_problem(jstruct.tri_mesh(4, 4, 0.25, 0.25), jc)
    tp = tsemi.build_problem(tstruct.tri_mesh(4, 4, 0.25, 0.25), tc)
    assert_same(jp.coords_fine, tp.coords_fine, "coords_fine")
    assert_same(jp.analytical, tp.analytical, "analytical")
    assert len(jp.levels) == len(tp.levels) == n_split + 1
    for li, (jL, tL) in enumerate(zip(jp.levels, tp.levels)):
        assert (jL["C"], jL["s"]) == (tL["C"], tL["s"])
        assert set(jL["_np"]) == set(tL) - {"C", "s"}
        for key, val in jL["_np"].items():
            assert_same(val, tL[key], f"level {li} {key}")
        jd = jstencil.build_stencil(jL, jc.physics, jc.dt, jc.theta)
        td = tstencil.build_stencil(tL, tc.physics, tc.dt, tc.theta)
        for f in dataclasses.fields(jstencil.StencilData):
            if f.name == "slot_mf":
                assert jd.slot_mf is None and td.slot_mf is None
                continue
            assert_same(getattr(jd, f.name), getattr(td, f.name),
                        f"level {li} StencilData.{f.name}")
        for a, b in zip(jstencil.slot_groups(jd), tstencil.slot_groups(td)):
            if isinstance(a, list):
                for ga, gb in zip(a, b):
                    assert_same(ga, gb, "slot_groups")
            else:
                assert np.array_equal(a, b)
        lam_j = jstencil.StencilOperator(jd, np.dtype(dtype)
                                         ).lam_max_estimate()
        lam_t = tstencil.lam_max_estimate(td)
        assert lam_j == lam_t
        assert (jsmooth.chebyshev_roots(lam_j, 6, 0.1)
                == tsmooth.chebyshev_roots(lam_t, 6, 0.1))
        assert_same(jstencil.inv3x3(jd.self_blocks),
                    tstencil.inv3x3(td.self_blocks), "inv3x3")
        if li == len(jp.levels) - 1:
            assert_same(jstencil.to_dense(jd), tstencil.to_dense(td),
                        "to_dense")


def test_penalty_dx_path():
    """sip_consistency=False takes the centroid-distance penalty."""
    kw = dict(n_split=2, multi_levels=2, dt=0.05, dtype="float64")
    jc = jcfg.SemiConfig(physics=jcfg.Physics(sip_consistency=False), **kw)
    tc = tcfg.SemiConfig(physics=tcfg.Physics(sip_consistency=False), **kw)
    jp = jsemi.build_problem(jstruct.tri_mesh(6, 3, 0.3, 0.2), jc)
    tp = tsemi.build_problem(tstruct.tri_mesh(6, 3, 0.3, 0.2), tc)
    for jL, tL in zip(jp.levels, tp.levels):
        assert_same(jL["_np"]["inv_dx"], tL["inv_dx"], "inv_dx")


def test_config_defaults_match():
    """Every field of the port is the JAX package's, with its default, so
    one set of the port's kwargs configures both (the port leaves out the
    fields of paths it does not run yet); RectConfig has them all.  The
    one departure is ``stencil_max_children``: 4**7 = 16,384 in the port,
    the deepest split of the reference's scaling study (kernel K1 streams
    its fine level), 4,096 in the JAX package, where the TPU's stencil
    cost outgrew its benefit above it."""
    departs = {"stencil_max_children": (4096, 16384)}
    for jc, tc in ((jcfg.SemiConfig(), tcfg.SemiConfig()),
                   (jcfg.Physics(), tcfg.Physics()),
                   (jcfg.ProblemFns(), tcfg.ProblemFns()),
                   (jcfg.RectConfig(), tcfg.RectConfig())):
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        for d in (jd, td):
            d.pop("physics", None)
            d.pop("fns", None)
            if "solver" in d:
                d["solver"] = d["solver"].value
        for name, (jax_default, port_default) in departs.items():
            if name in td:
                assert (jd.pop(name), td.pop(name)) == (jax_default,
                                                        port_default)
        assert td == {k: jd[k] for k in td}
    assert tcfg.SemiConfig().stencil_max_children == 4 ** 7
    assert (dataclasses.asdict(tcfg.RectConfig())
            == dataclasses.asdict(jcfg.RectConfig()))
    assert tcfg.SemiConfig().fast_operator is True

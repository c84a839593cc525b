"""The port's transport solvers (modes 2-6) == the JAX package's, float64 on
the CPU, and the reference's own acceptance tests on the port.

``transport.solve`` runs each mode's configuration (explicit theta = 0;
implicit theta-schemes by PCG, or BiCGStab under advection, with and
without the Rannacher start) to the JAX package's final state at 1e-10.
Then the port alone: the steady mixed Dirichlet/no-flux diffusion solution
is exact, and the erfc breakthrough gate (L1 < 0.01, inlet pinned within
0.01) passes on the generated strip (tests/test_transport.py:16-70).
"""

import torch_threads  # noqa: F401

import dataclasses

import numpy as np
import pytest

from p_a_multigrids_tpu import config as jcfg
from p_a_multigrids_tpu.mesh import structured as jstruct
from p_a_multigrids_tpu.models import transport as jtransport

from p_a_multigrids_tpu_torch import config as tcfg
from p_a_multigrids_tpu_torch.mesh import splitting, structured
from p_a_multigrids_tpu_torch.models import transport
from p_a_multigrids_tpu_torch.validation import analytical as va
from p_a_multigrids_tpu_torch.validation import gates, probe


def _blob(x, y):
    return np.exp(-60.0 * ((np.asarray(x) - 0.3) ** 2
                           + (np.asarray(y) - 0.5) ** 2))


def _zero(x, y):
    return np.zeros_like(np.asarray(x))


# TransportConfig fields of each case; every run starts from a Gaussian blob
MODES = {
    # modes 2 / 4: explicit advection, theta = 0, one block solve a step
    "explicit_advection": dict(ntime=4, dt=2e-3, u=(1.0, 0.0), k=0.0,
                               diffusion=False, implicit=False),
    # mode 3 / 5: implicit Crank-Nicolson advection, BiCGStab, Rannacher
    "implicit_advection_cn": dict(ntime=4, dt=0.02, u=(1.0, 0.5), k=0.0,
                                  implicit=True, theta=0.5),
    # mode 6: advection-diffusion, Crank-Nicolson, BiCGStab, Rannacher
    "diffusion_advection_cn": dict(ntime=4, dt=0.01, u=(1.0, 0.0), k=1.0,
                                   diffusion=True, implicit=True,
                                   theta=0.5),
    # mode 6 without advection: PCG, theta = 1
    "diffusion_implicit": dict(ntime=2, dt=0.01, u=(0.0, 0.0), k=1.0,
                               diffusion=True, implicit=True, theta=1.0),
    # Crank-Nicolson without the Rannacher start
    "diffusion_cn_no_rannacher": dict(ntime=3, dt=0.01, u=(0.0, 0.0),
                                      k=1.0, diffusion=True, implicit=True,
                                      theta=0.5, rannacher=False),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_solve_matches_jax(mode):
    kw = dict(MODES[mode], dtype="float64")
    mesh_args = (8, 6, 1 / 8, 1 / 6)
    jf = jcfg.ProblemFns(bc=_zero, ic=_blob)
    tf = tcfg.ProblemFns(bc=_zero, ic=_blob)
    _, Tj = jtransport.solve(jstruct.tri_mesh(*mesh_args),
                             jcfg.TransportConfig(**kw), fns=jf)
    solver, Tt = transport.solve(structured.tri_mesh(*mesh_args),
                                 tcfg.TransportConfig(**kw), fns=tf,
                                 device="cpu")
    assert solver.ops[0].C == 1 and tuple(Tt.shape) == (96, 1, 3)
    assert solver.cfg.krylov == kw["implicit"]
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-10,
                               atol=1e-10)
    assert float(np.abs(Tt.numpy()).max()) > 0.01


def test_semi_cfg_matches_jax():
    """Every field of the SemiConfig the transport modes build is the JAX
    package's, but the stencil cap, each package's own default (the
    port's one departure, ``tests/test_torch_setup.py``), which at their
    split depth 0 takes the stencil path in both."""
    for kw in MODES.values():
        want = jtransport._semi_cfg(jcfg.TransportConfig(**kw),
                                    jcfg.ProblemFns())
        got = transport._semi_cfg(tcfg.TransportConfig(**kw),
                                  tcfg.ProblemFns())
        for f in dataclasses.fields(got):
            if f.name in ("physics", "fns", "solver"):
                continue
            if f.name == "stencil_max_children":
                assert (getattr(got, f.name), getattr(want, f.name)) == (
                    tcfg.SemiConfig().stencil_max_children,
                    jcfg.SemiConfig().stencil_max_children)
                assert 4 ** got.n_split <= min(got.stencil_max_children,
                                               want.stencil_max_children)
                continue
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.solver.value == want.solver.value
        assert dataclasses.asdict(got.physics) == dataclasses.asdict(
            want.physics)


def _strip(nx, ny):
    return structured.tri_mesh(nx, ny, 2.0 / nx, 0.1 / ny)


def test_steady_mixed_bc_exact():
    """Linear steady diffusion with Dirichlet ends and no-flux walls is
    exact (the Neumann machinery and the Krylov implicit path)."""
    mesh = _strip(20, 2)
    tol = 1e-9
    fns = tcfg.ProblemFns(
        bc=lambda x, y: np.where(np.asarray(x) < tol, 1.0, 0.0),
        neumann=lambda x, y: (np.asarray(x) > tol) & (np.asarray(x) < 2 - tol),
        ic=_zero)
    cfg = tcfg.TransportConfig(ntime=2, dt=1e9, u=(0.0, 0.0), k=1.0,
                               diffusion=True, implicit=True, theta=1.0,
                               dtype="float64")
    _, T = transport.solve(mesh, cfg, fns=fns, device="cpu")
    coords = splitting.child_coords(mesh.X, 0).reshape(-1, 2, 3)
    xs, sampled = probe.line_probe(coords, T.numpy().reshape(-1, 3),
                                   y=0.025, x0=0.0, x1=2.0, n=9)
    assert np.allclose(sampled, 1.0 - xs / 2, atol=1e-6)


def test_breakthrough_erfc_gate():
    """The reference's erfc advection-diffusion validation at L1 < 0.01 on
    the generated 60 x 3 strip: Crank-Nicolson, u = (1, 0), 40 steps,
    Rannacher start, no-flux walls."""
    setup = transport.BreakthroughSetup()
    mesh = _strip(60, 3)
    fns = transport.breakthrough_fns(setup, x_len=2.0)
    ntime = 40
    cfg = tcfg.TransportConfig(ntime=ntime, dt=setup.t_end / ntime,
                               u=(1.0, 0.0), k=1.0, diffusion=True,
                               implicit=True, theta=0.5, dtype="float64")
    _, T = transport.solve(mesh, cfg, fns=fns, device="cpu")
    coords = splitting.child_coords(mesh.X, 0).reshape(-1, 2, 3)
    xs, sampled = probe.line_probe(coords, T.numpy().reshape(-1, 3),
                                   y=0.0333, x0=0.0, x1=1.0, n=202)
    g = gates.check(sampled, va.breakthrough_erfc(xs, setup.t_end,
                                                  setup.gamma))
    assert g.passed, str(g)
    # Rannacher startup keeps the inlet pinned (CN alone rings to ~0.84)
    assert abs(sampled[0] - 1.0) < 0.01

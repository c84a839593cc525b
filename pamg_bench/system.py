"""The system under test, through the port's public constructors, and
what the benchmark records around it.

The benchmark takes from the program only its solver, its launch and
iteration counters, and the module-level callables it wraps:

- always, ``ops.krylov.pcg`` (where ``models/semi`` looks it up): each
  solve's outcome, whether its returned residual norm met the stop rule
  ||r|| <= tol max(||b||, 1e-30), kept as a device flag and read after the
  window, so that a solve stopped by ``krylov_maxiter`` or a breakdown
  counts as failed;
- in a traced run only, record ranges (spans) around the calls that the
  per-layer metrics read: ``phase`` as ``models/semi`` calls it (kernel
  K1), ``RowOp.forward`` (kernel K2), ``SemiSolver._rhs_t`` (the theta
  right-hand side) and the Krylov solve, each K1 and K2 call with the
  least bytes it must move (``yardstick``).
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import yardstick

SPANS = ("k1", "k2", "rhs", "krylov", "step")


def build(cell, device):
    """The cell's solver, built as the CLI builds it."""
    from p_a_multigrids_tpu_torch.config import SemiConfig
    from p_a_multigrids_tpu_torch.mesh import structured
    from p_a_multigrids_tpu_torch.models import semi

    mesh = structured.tri_mesh(*cell.config["mesh"]["tri_mesh"])
    cfg = SemiConfig(**cell.semi_fields())
    return semi.SemiSolver(semi.build_problem(mesh, cfg), device)


def launch_counts() -> dict:
    """The program's own launch counts of K1 and K2."""
    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops import spmv as K2
    return {"k1_phase": K.KERNEL.launches, "k2_rowop": K2.KERNEL.launches}


class Recorder:
    """The wrappers above, installed on entry and taken off on exit.

    ``solves``: one device flag a Krylov solve, True when its stop rule
    was met.  With ``spans``, ``calls[name]`` counts the spanned calls and
    ``bytes[name]`` sums the least bytes of the K1 and K2 calls."""

    def __init__(self, spans: bool):
        self.spans = spans
        self.solves: list = []
        self.calls = dict.fromkeys(SPANS, 0)
        self.bytes = {"k1": 0, "k2": 0}
        self._rowop_bytes: dict = {}
        self._stack = contextlib.ExitStack()

    def count_rowops(self, solver):
        """Least bytes of every K2 operator of the solver, read before the
        window (reading them syncs with the card)."""
        from p_a_multigrids_tpu_torch.ops.spmv import RowOp
        for m in solver.modules():
            if isinstance(m, RowOp):
                self._rowop_bytes[id(m)] = yardstick.rowop_least_bytes(
                    m, m.vals_t.element_size())

    def reset(self):
        self.solves.clear()
        self.calls = dict.fromkeys(SPANS, 0)
        self.bytes = {"k1": 0, "k2": 0}

    def span(self, name: str):
        """A record range named ``name`` when spans are on, counted."""
        if not self.spans:
            return contextlib.nullcontext()
        self.calls[name] += 1
        return torch.profiler.record_function(name)

    def failed_steps(self, residuals: list) -> int:
        """Steps whose residual read is not finite or whose solve (one a
        step, where there are solves) missed its stop rule."""
        bad = [not math.isfinite(r) for r in residuals]
        if self.solves:
            met = torch.stack(self.solves).cpu().tolist()
            if len(met) != len(bad):
                raise RuntimeError(f"{len(met)} Krylov solves in "
                                   f"{len(bad)} steps")
            bad = [b or not m for b, m in zip(bad, met)]
        return sum(bad)

    def __enter__(self):
        from p_a_multigrids_tpu_torch.models import semi
        from p_a_multigrids_tpu_torch.ops import krylov, spmv

        rec = self
        pcg = krylov.pcg

        def pcg_recorded(apply_A, b, x0, precond=None, tol=1e-8,
                         maxiter=200, **kw):
            with rec.span("krylov"):
                x, it, rn = pcg(apply_A, b, x0, precond=precond, tol=tol,
                                maxiter=maxiter, **kw)
            bn = torch.linalg.vector_norm(b).clamp(min=1e-30)
            rec.solves.append(rn <= tol * bn)
            return x, it, rn

        self._patch(krylov, "pcg", pcg_recorded)
        if self.spans:
            phase = semi.phase
            forward = spmv.RowOp.forward
            rhs = semi.SemiSolver._rhs_t

            def phase_spanned(op, x_t, bp_t, coefs, want_z=True):
                rec.bytes["k1"] += yardstick.least_bytes(
                    op.C, op.U, x_t.element_size(),
                    yardstick.phase_planes(coefs, want_z))
                with rec.span("k1"):
                    return phase(op, x_t, bp_t, coefs, want_z)

            def forward_spanned(op, x_t):
                rec.bytes["k2"] += rec._rowop_bytes[id(op)]
                with rec.span("k2"):
                    return forward(op, x_t)

            def rhs_spanned(solver, told_t):
                with rec.span("rhs"):
                    return rhs(solver, told_t)

            self._patch(semi, "phase", phase_spanned)
            self._patch(spmv.RowOp, "forward", forward_spanned)
            self._patch(semi.SemiSolver, "_rhs_t", rhs_spanned)
        return self

    def _patch(self, owner, name, fn):
        old = getattr(owner, name)
        setattr(owner, name, fn)
        self._stack.callback(setattr, owner, name, old)

    def __exit__(self, *exc):
        self._stack.close()
        return False

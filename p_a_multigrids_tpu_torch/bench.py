"""Benchmark of the port: time per V-cycle, convergence, the amg PCG solve,
SpMV, the L1 gate and the level sweep, on one GPU.

    python -m p_a_multigrids_tpu_torch.bench [--device cuda|cpu]

The counterpart of the JAX system's ``bench.py``: the same measurements on
the same configurations, printed as ONE JSON line of the same shape on
stdout ({"metric", "value", "unit", "vs_baseline", "extra"}); progress
marks go to stderr.  It runs on the card unless the caller asks for the
CPU: every relaxation phase and stencil apply launches kernel K1, every SA
rowop and the SpMV row kernel K2.

What differs from ``bench.py``:

- the meshes are generated stand-ins (``BENCH_MESH`` for untitled8192.msh,
  393,216 DOF at n_split 2; ``utils.profiling.SWEEP_MESH`` for the
  multigrid_meshes/2_split.msh family, 294,912 DOF at n_split 5), which
  ``extra.stand_in_for`` names;
- each timed window is eager PyTorch: ``reps`` windows of ``n`` back-to-back
  steps, timed by CUDA events with one synchronise at the window's end,
  after one untimed warm-up call that builds the kernels;
  the K1 and K2 libraries are built before the setup timer starts;
- the port's PCG reads its residual norm on the host once an iteration,
  and that read is inside the timed window of ``pcg_ms_to_1e6``;
- the TPU names become the port's: ``k2_spmv`` (K2 ran the SpMV row),
  ``k1_phase`` (K1 ran the geometric cycle), ``k1_tiers`` (the tiers K1's
  plans chose there) and ``spmv_library_gnnz_s`` (the same product through
  ``torch.sparse_bsr_tensor``, cuSPARSE on the card);
- ``extra.device`` is the card's name and power limit as nvidia-smi gives
  them, ``extra.launches`` the kernels' launches over the run;
- the history rho is trimmed where the residual reaches the floor it stays
  on (every later residual above ``PLATEAU`` times it), not at the first
  single cycle-to-cycle ratio above ``PLATEAU``;
- each section runs once, without a fallback: a section that raises
  leaves ``{"error": ...}`` (or nulls) in its place and its message in
  ``extra.errors``, the line is still printed, and the process exits 1;
  ``extra.rho`` is null when the amg section failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import subprocess
import sys
import time

import numpy as np
import torch

from .config import SemiConfig
from .mesh import structured
from .models import semi, semi_assembled
from .ops import krylov
from .ops import phase as K
from .ops import spmv as K2
from .ops.fused import to_t
from .utils import profiling

# the stand-in for untitled8192.msh: 4,096 macros of 3:1 stretched right
# triangles, 393,216 DOF at n_split 2
BENCH_MESH = (128, 32, 3 / 128, 1 / 128)
# the configurations, SemiConfig fields: the geometric headline (2-level
# V(4,4), one degree-8 Chebyshev coarse phase; coarse_pack is accepted and
# does nothing), the production bare iteration (strength-filtered SA of
# the finest level) and the manufactured-solution gate (steady diffusion by
# PCG)
GEOMETRIC = dict(dt=0.05, n_split=2, multi_levels=2, coarse_agg=False,
                 coarse_cheb_degree=8, coarse_cheb_lower=0.02, coarse_pack=4)
AMG = dict(dt=0.05, n_split=2, multi_levels=1, amg=True, agg_strength=0.5,
           cheb_degree=16, cheb_lower=0.05)
GATE = dict(dt=1e8, n_split=2, multi_levels=3, krylov=True, krylov_tol=1e-9)
# the reference's multigrid level sweep: 294,912 DOF, ~6.5 s a V-cycle
# (serial -O0 x86, BASELINE.md), scaled by the DOF ratio
REF_S_PER_VCYCLE = 6.5
REF_DOF = 294912
# the residual has reached its floor at a cycle when every later residual
# stays above this share of it: the rounding floor, not the iteration
PLATEAU = 0.9
PCG_CHAIN = 3

_T0 = time.time()


def _mark(msg: str) -> None:
    """Phase timing on stderr (stdout carries only the JSON line)."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _timed(step, x0, n, reps=3):
    """Best-of-reps seconds per call of step, over windows of n
    back-to-back calls from x0 (each feeding the next), after one untimed
    warm-up call.  On the card CUDA events time each window, with one
    synchronise at its end; on the CPU ``time.perf_counter``."""
    cuda = x0.device.type == "cuda"
    step(x0)
    if cuda:
        torch.cuda.synchronize(x0.device)
    best = float("inf")
    for _ in range(reps):
        x = x0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                x = step(x)
            end.record()
            end.synchronize()
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                x = step(x)
            s = time.perf_counter() - t0
        best = min(best, s)
    return best / n


def _solver_for(mesh, dt, device, dtype="float32", **kw):
    """A SemiSolver of one step and one cycle on ``device`` (``dtype``
    other than float32 only in the tests)."""
    cfg = SemiConfig(dt=dt, ntime=1, n_multigrid=1, dtype=dtype, **kw)
    return semi.SemiSolver(semi.build_problem(mesh, cfg), device)


def _rho_from_history(norms, skip=2):
    """Asymptotic contraction of a residual history: the geometric mean of
    the ratios from cycle ``skip`` up to the floor, the first cycle whose
    residual every later one stays above PLATEAU times (a single ratio
    above PLATEAU followed by a further fall is no floor; without a floor,
    the last cycle); at least one ratio."""
    norms = np.asarray(norms, np.float64)
    later_min = np.append(np.minimum.accumulate(norms[::-1])[::-1][1:],
                          np.inf)
    floor = skip + int(np.argmax(later_min[skip:] > PLATEAU * norms[skip:]))
    last = max(floor, skip + 1)
    with np.errstate(divide="ignore"):
        return float((norms[last] / norms[skip]) ** (1.0 / (last - skip)))


def _vcycle_stats(solver, n_rho=10, skip=2, n_time=100):
    """(sec/cycle, rho, norms): time per level-0 cycle in the transposed
    layout, and the residual max|b - A x| after each of n_rho cycles from
    the initial condition, with its asymptotic contraction
    (``_rho_from_history``)."""
    T_t = to_t(solver.initial_condition())
    b_t = solver._rhs_t(T_t)
    per_cycle = _timed(lambda x: solver._vcycle_t(0, x, b_t), T_t,
                       n=n_time)
    x, norms = T_t, []
    for _ in range(n_rho):
        x = solver._vcycle_t(0, x, b_t)
        norms.append((b_t - solver._apply_t(0, x, True)).abs().max())
    norms = torch.stack(norms).double().cpu().numpy()
    return per_cycle, _rho_from_history(norms, skip), norms


def _t_to(per_cycle, rho, drop=1e-6):
    return (per_cycle * math.log(drop) / math.log(rho)
            if 0 < rho < 1 else float("inf"))


def _rho_linear(solver, n=8, draw_dtype=None):
    """Spectral contraction of the linear error-propagation operator:
    x <- cycle(x, b = 0) from a random unit vector (drawn in the (U, C, 3)
    layout, as the JAX package draws it, rounded to ``draw_dtype`` and cast
    to the solver's dtype; by default drawn in the solver's dtype),
    renormalised every cycle; the geometric mean of the factors after the
    first two."""
    T = solver.initial_condition()
    rng = np.random.default_rng(0)
    dtype = np.dtype(solver.cfg.dtype)
    x = to_t(torch.as_tensor(rng.normal(size=tuple(T.shape))
                             .astype(draw_dtype or dtype).astype(dtype),
                             device=T.device))
    zero = torch.zeros_like(x)
    x = x / torch.linalg.norm(x)
    factors = []
    for _ in range(n):
        x = solver._vcycle_t(0, x, zero, hom=True)
        nrm = torch.linalg.norm(x)
        factors.append(nrm)
        x = x / torch.clamp(nrm, min=1e-30)
    factors = torch.stack(factors).double().cpu().numpy()
    return float(np.exp(np.mean(np.log(np.maximum(factors[2:], 1e-30)))))


def _pcg_chain(solver, solves=PCG_CHAIN):
    """(iterations, ms a solve) of PCG to a 1e6 residual drop (tol 1e-6,
    x0 = 0), preconditioned by the homogeneous level-0 cycle: ``solves``
    solves chained, each right-hand side seeded by 1e-30 * sum(x) of the
    previous solution; the iterations are the first solve's."""
    T_t = to_t(solver.initial_condition())
    b_t = solver._rhs_t(T_t)
    b_lin = b_t - solver._apply_t(0, torch.zeros_like(b_t), True)
    its = []

    def chain(b):
        for _ in range(solves):
            x, it, _ = krylov.pcg(
                lambda v: solver._apply_t(0, v, False), b,
                torch.zeros_like(b),
                precond=lambda r: solver._vcycle_t(0, torch.zeros_like(r),
                                                   r, hom=True),
                tol=1e-6, maxiter=40)
            its.append(it)
            b = b + 1e-30 * x.sum()
        return b

    per_chain = _timed(chain, b_lin, n=1)
    return its[0], per_chain / solves * 1e3


def _sweep_row(solver, config: str) -> dict:
    """One row of the level sweep: ms a cycle, history rho and ms to a
    1e6 drop."""
    pc, rh, _ = _vcycle_stats(solver, n_rho=10, n_time=30)
    return {"ms_per_cycle": round(pc * 1e3, 3), "rho": round(rh, 4),
            "config": config, "ms_to_1e6": round(_t_to(pc, rh) * 1e3, 2)}


def _free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU."""
    if device.type != "cuda":
        return f"cpu {platform.machine()}, {os.cpu_count()} threads"
    idx = device.index if device.index is not None else 0
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={idx}"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()


def _r(x, digits):
    return None if x is None else round(x, digits)


def _amg(mesh, device) -> dict:
    """The production bare-iteration configuration (strength-filtered SA
    of the finest level): its cycle, rho, PCG solve and the V(1,1) row."""
    s_amg = _solver_for(mesh, device=device, **AMG)
    _mark("amg solver built")
    per_amg, rho_hist, norms_amg = _vcycle_stats(s_amg, n_time=30)
    rho_amg = _rho_linear(s_amg)
    amg = {"ms_per_cycle": round(per_amg * 1e3, 3),
           "rho": round(rho_amg, 4),
           "rho_from_history": round(rho_hist, 4),
           "ms_to_1e6": round(_t_to(per_amg, rho_amg) * 1e3, 2),
           "residual_history": [float(f"{v:.4e}") for v in norms_amg]}
    _mark("amg stats done")
    its, pms = _pcg_chain(s_amg)
    amg["pcg_its_to_1e6"] = its
    amg["pcg_ms_to_1e6"] = round(pms, 2)
    _mark("amg pcg done")
    del s_amg
    _free(device)
    s_v11 = _solver_for(mesh, device=device, agg_sweeps=1, **AMG)
    per_v11, _, _ = _vcycle_stats(s_v11, n_rho=4, n_time=30)
    its1, pms1 = _pcg_chain(s_v11)
    amg["v11"] = {"ms_per_cycle": round(per_v11 * 1e3, 3),
                  "pcg_its_to_1e6": its1, "pcg_ms_to_1e6": round(pms1, 2)}
    _mark("amg v11 done")
    return amg


def _spmv(solver, device) -> dict:
    """The assembled level-0 operator (E x 4 blocks): K2 on the transposed
    (3, E) vector and the library's BSR product, 100 applies chained, best
    of 3."""
    cfg = solver.cfg
    A = semi_assembled.assemble_operator(solver.p.levels[0], cfg.physics,
                                         cfg.dt, cfg.theta)
    op = A.rowop(torch.float32, device)
    E = A.num_rows
    x0 = np.random.default_rng(0).normal(size=(E, 3)).astype(np.float32)
    x0_t = torch.tensor(np.ascontiguousarray(x0.T), device=device)
    before = K2.KERNEL.launches
    spmv_s = _timed(op, x0_t, n=100)
    launched = K2.KERNEL.launches > before
    M = profiling.bsr_matrix(op)
    lib_s = _timed(lambda v: M @ v, torch.tensor(x0.reshape(-1),
                                                  device=device), n=100)
    _mark("spmv bench done")
    return {"spmv_s": spmv_s, "library_s": lib_s, "k2": launched}


def _sweep(device) -> tuple:
    """The level sweep (W-cycles, degree-6 Chebyshev, levels 1-6 at
    n_split 5) and its production amg row; each solver is freed before
    the next is built.  Returns (rows, {row: error})."""
    sweep, failed = {}, {}

    def row(key, build, config):
        # the solver lives only inside _sweep_row's call
        try:
            sweep[key] = _sweep_row(build(), config)
            _mark(f"sweep {key} measured ({config})")
        except Exception as e:
            sweep[key] = {"error": _message(e)}
            failed[f"level_sweep.{key}"] = sweep[key]["error"]
            _mark(f"sweep {key} failed")
        _free(device)

    for lv in (1, 2, 3, 4, 5, 6):
        row(str(lv), lambda: profiling.sweep_solver(device, lv), "deg6-w")
    ms = [v["ms_to_1e6"] for v in sweep.values()
          if "ms_to_1e6" in v and math.isfinite(v["ms_to_1e6"])]
    if ms:
        sweep["max_over_min_ms_to_1e6"] = round(max(ms) / min(ms), 2)
    row("production_amg_deg16", lambda: profiling.deep_amg_solver(device),
        "amg-deg16-s0.5")
    return sweep, failed


def _message(e: Exception) -> str:
    return f"{type(e).__name__}: {e}"[:200]


def main(argv=None) -> int:
    """Run the benchmark, print its JSON line; 0, or 1 when a section
    failed."""
    ap = argparse.ArgumentParser(prog="p_a_multigrids_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: no CUDA device (--device cpu runs on "
                             "the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
        torch.zeros(1, device=device)
        K.KERNEL.function(torch.float32)     # the builds stay out of setup_s
        K2.KERNEL.function(torch.float32)
        _mark("kernels built")
    errors = {}

    def section(name, fn):
        try:
            return fn()
        except Exception as e:
            errors[name] = _message(e)
            _mark(f"{name} failed: {errors[name]}")
            return None

    mesh = structured.tri_mesh(*BENCH_MESH)

    # -- geometric headline ---------------------------------------------------
    def geometric():
        t0 = time.time()
        s = _solver_for(mesh, device=device, **GEOMETRIC)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.time() - t0
        _mark(f"setup done ({setup_s:.1f}s)")
        before = dict(K.KERNEL.by_tier)
        per, rho, norms = _vcycle_stats(s)
        _mark("geometric vcycle stats done")
        tiers = sorted(t for t, n in K.KERNEL.by_tier.items()
                       if n > before[t])
        return {"solver": s, "setup_s": setup_s, "per": per, "rho": rho,
                "norms": norms, "k1": bool(tiers), "tiers": tiers}

    geo = section("geometric", geometric) or {}
    amg = section("amg", lambda: _amg(mesh, device))
    amg = amg if amg is not None else {"error": errors["amg"]}

    U = mesh.num_elements
    C = 4 ** 2
    ndof = U * C * 3
    # block-nnz touched per fine operator application (self + 3 face blocks)
    nnz = U * C * 4 * 9
    # V(4,4), cheb degree 6: 12 fine sweeps + residual; coarse at C/4
    apps = 13 + 13 / 4
    per = geo.get("per")
    roof = (profiling.operator_roofline(U, C, 3, per / apps)
            if per is not None else None)

    def spmv():
        if "solver" not in geo:
            raise RuntimeError("needs the geometric solver, which failed")
        return _spmv(geo.pop("solver"), device)

    sp = section("spmv", spmv) or {}
    geo.pop("solver", None)
    _free(device)

    # -- manufactured-solution L1 gate: steady diffusion by PCG -----------
    def gate():
        g = _solver_for(mesh, device=device, **GATE)
        _mark("gate solver built")
        Tg = g.run()
        _mark("gate solve done")
        return float(g.error(Tg).mean())

    l1 = section("gate", gate)
    _free(device)

    sw = section("level_sweep", lambda: _sweep(device))
    if sw is None:
        sweep = {"error": errors["level_sweep"]}
    else:
        sweep, failed = sw
        errors.update(failed)
    dev_name = section("device", lambda: _device_name(device))

    rho_geo = geo.get("rho")
    result = {
        "metric": (f"time_per_vcycle_tri{BENCH_MESH[0]}x{BENCH_MESH[1]}"
                   f"_nsplit2"),
        "value": _r(per * 1e3 if geo else None, 3),
        "unit": "ms",
        "vs_baseline": _r(REF_S_PER_VCYCLE * ndof / REF_DOF / per if geo
                          else None, 2),
        "extra": {
            "ndof": ndof,
            "setup_s": _r(geo.get("setup_s"), 2),
            # production bare-iteration contraction (the amg section)
            "rho": amg.get("rho"),
            "geometric": {
                "ms_per_cycle": round(per * 1e3, 3),
                "rho": round(rho_geo, 4),
                "ms_to_1e6": round(_t_to(per, rho_geo) * 1e3, 2),
                "residual_history": [float(f"{v:.4e}")
                                     for v in geo["norms"]],
            } if geo else {"error": errors["geometric"]},
            "amg": amg,
            "l1_err": l1,
            "l1_gate_passed": None if l1 is None else bool(l1 < 0.01),
            "op_gnnz_s": _r(nnz * apps / per / 1e9 if geo else None, 2),
            "op_achieved_gbps": _r(roof.achieved_gbps if geo else None, 1),
            "spmv_gnnz_s": _r(nnz / sp["spmv_s"] / 1e9 if sp else None, 2),
            "spmv_library_gnnz_s": _r(nnz / sp["library_s"] / 1e9 if sp
                                      else None, 2),
            "k2_spmv": sp.get("k2"),
            "k1_phase": geo.get("k1"),
            "k1_tiers": geo.get("tiers"),
            "level_sweep_2split_nsplit5": sweep,
            "stand_in_for": (
                f"untitled8192.msh: tri_mesh{BENCH_MESH}; "
                f"multigrid_meshes/2_split.msh: "
                f"tri_mesh{profiling.SWEEP_MESH}"),
            "device": dev_name,
            # the kernels' launches over the whole run (K1 on levels of
            # more than 64 children: the level sweep's)
            "launches": {"k1_phase": K.KERNEL.launches,
                         "k1_phase_deep": K.KERNEL.launches_deep,
                         "k2_rowop": K2.KERNEL.launches},
            "errors": errors,
        },
    }
    print(json.dumps(result), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

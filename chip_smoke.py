#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (p_a_multigrids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds kernels K1 (csrc/phase.cu: one launch per relaxation phase, in its
small, resident or streaming tier) and K2 (csrc/spmv.cu: one thread or a
group of lanes per block row) from this checkout, holds each against its
plain PyTorch version at the main paths' shapes (K1 in each tier),
drives the mode-9 main paths through the CLI entry at full width (the
geometric V-cycle, the production smoothed-aggregation PCG solve, and the
CLI defaults, whose coarsest level continues into SA levels), runs the
benchmark's geometric and amg V-cycle configurations, the amg PCG solve to
1e-6 and the manufactured-solution PCG gate, counts K1's launches and
rounds in one cycle of each configuration, times both kernels against their
plain versions, their bounds and, for K2, the library call that computes
the same product (a sparse BSR matrix times a vector), and holds the
production CLI run to the same command on the host CPU (the plain PyTorch
path, f32).

Then the deep-split path (n_split 5, C = 1024 children per macro, where
the TPU ran its kernel PhaseOperatorResident): K1 against its plain version
at every level of the level sweep's solvers, K2 against its plain version
on every SA operator of the deep hierarchies, the Galerkin solver's coarse
blocks against P^T A P recomputed here, the sweep at 294,912 DOF with 1-6
levels, its Galerkin configuration and its amg row held to the JAX
package's f32 histories, the CLI with --mesh on a gmsh file it writes, held
to the same command on the host CPU, and K1 timed at C = 1024.

Then the other modes: mode 10 at 393,216 DOF (K2 against its plain version
on the assembled 131,072 x 4 operator, one launch a block-Jacobi sweep,
timed beside its bound and the library call), mode 8 at the CLI defaults
(the 5.9 GB dense inverse on the card, held to mode 9's PCG), mode 7 (the
explicit theta = 0 step), mode 9 with BiCGStab and with Crank-Nicolson,
mode 6 at n_split 0 on a 256 x 256 gmsh file (K1 at C = 1, U = 131,072
against its plain version and timed) and the erfc breakthrough gate, each
held to the same command on the host CPU or to the JAX package's f32
values where they are recorded.

Then the solver menu, the non-stencil path and mode 1: (a) the reference's
active mode-9 configuration (point Jacobi, no surface terms, the
corner-average restrictor) at 393,216 DOF, its operator applies through K1
and the SA levels below its 98,304-DOF coarsest through K2; (b) colored
Gauss-Seidel and Richardson on the geometric CLI path, and --solver direct
against --solver jacobi bit for bit; (c) Chebyshev through the fused
operator at n_split 7 (393,216 DOF), which launches neither kernel; (d)
the stencil probed from apply_A at the bench size, its blocks against the
closed form and one V-cycle through K1 against the analytic one; (e) mode
1 at the reference's 200 x 1 quads and at 200 x 1024 (819,200 DOF), with
the moving box's centre of mass and mass.  Each path prints its launches
by kernel, ms a step by CUDA events and its history beside the JAX
package's f32 values and the port's CPU run.

Then user-defined problems (slice 7): the CLI's mode 9 at 393,216 DOF with
--ic/--bc/--source/--analytical expressions that build the manufactured
problem, geometric and with --amg --krylov, each equal bit for bit to the
built-in problem with the same launches; a .geo annulus meshed by mesh_geo
(2,048 macros, 393,216 DOF at n_split 3) through the CLI with PCG, its
V-cycle history held to the JAX package's pin on the same mesh; every
other history pin of validation/history_pins.json on the card (the bench
stand-in, the .geo square at n_split 4 in K3's regime, the amg pins);
checkpoint and resume (4 steps straight against 2 + 2, bit for bit) and a
--vtk-interval series read back at full width; and the sanitizer: the
checked builds of K1 and K2 under --debug (the same launches and bits as
the unchecked run, their device time beside the unchecked one, a NaN
initial condition and one index set out of range by hand in a K1 and a K2
operator each raising from the kernels' error record).

Then the distributed solver (slice 8, phase 32): the geometric and the
production amg configurations on the bench stand-in at 1 rank (nccl), 2
and 4 ranks sharing the card (gloo, messages staged through host memory),
one spawn a world size; on the first and last rank K1 on every level's
extended-domain operators and K2 on every sharded SA rowop against their
plain versions; 10 geometric cycles equal to the serial solver on the
card bit for bit, amg within 2% + the f32 floor and its PCG count within
one; n_split 4 at 2 ranks over a halo wider than a rank's block, bit for
bit; ms a step with the share of host staging (the ranks share one card:
not a scaling measurement); and the CLI's --devices 2 on the card against
CPU ranks.

Then slice 9 (phase 33): the C++ mesh loaders, built with c++ at first use,
read painted_mesh(256) as a gmsh file and build its topology bit for bit as
the Python paths do (the seconds of each), and the mode-6 CLI runs on that
file; the production amg CLI with --profile DIR writes a trace whose K1 and
K2 kernels equal the wrappers' counts, with the history, Krylov counts and
state of the same run without it (wall time of both); and
SemiSolver.solve_system equals the CLI step's Krylov solve bit for bit,
through K1 and K2.  Then slice 10 (phase 34): mode 1's solve and the fused
operator given no device land on the card, bit for bit as with it;
smoothers.block_jacobi_inv over the zero-round K1 apply on the bench
stand-in's fine level (three sweeps, three K1 launches) against
block_jacobi_solve and the plain apply; BSR.to_dense on the card and
StencilOperator.lam_max_estimate against their host versions.

Then float64 (slice 11, phase 35): kernels K1 and K2 in double on every
path, through the same entry points with --f64 / dtype="float64": the
bench stand-in (its fine level in K1's streaming tier) held to the JAX
package's float64 pin bench:s2:l2, the annulus CLI held to its pin
annulus_geo:s3:cli and to the JAX package's float64 run, the production
amg CLI and the PCG gate, one 6-level W-cycle of the level sweep with each
of its phases held to phase_reference, mode 6 at 256 x 256 (BiCGStab's
iterations and the drop it reaches beside float32's) and mode 10; K1 in
each tier and K2 in both variants against their plain versions, the
checked builds' bits against the unchecked ones, each path's launches
against its float32 run's, and each kernel timed beside its float32 twin,
its bound at 8 bytes a value and, for the apply and K2, the library call.
Then the port's bench (slice 12, phase 36): ``python -m
p_a_multigrids_tpu_torch.bench`` in a process of its own, its JSON line
held to validation/bench_pins.json (the root bench.py's functions on the
JAX package): no section in error, K1 and K2 both ran, each rho within 2%
plus its pin's float32 floor, PCG iterations within one, the L1 gate.
Then the distributed bench (slice 13, phase 37): ``python -m
p_a_multigrids_tpu_torch.bench_dist`` on one rank (nccl) and on four ranks
sharing the card (gloo), its JSON lines held to
validation/bench_dist_pins.json (the JAX package's distributed solver):
every ghost report and model, work fraction and halo window equal to the
pins, the distributed state to the serial twin's (geometric within 1e-6,
sharded SA within 2%), K1 and K2 launched on the ranks.
Then the knob sweep (slice 14, phase 38): K1 on the fine phase of each
Chebyshev degree (16, 12, 10) and K2 on every rowop of the one-sweep SA
hierarchies at agg_target 4 and 8 against their plain versions, then
``python -m p_a_multigrids_tpu_torch.tune_amg`` in a process of its own,
its seven cases held to validation/tune_amg_pins.json (the JAX system's
scripts/tune_amg.py on the JAX package): no case in error, K1 and K2 in
every case, each rho within 2% plus its pin's float32 floor, PCG
iterations within one.
Every phase prints its numbers; any failure raises and
the script exits non-zero.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# JAX package on CPU, f32 (python -m p_a_multigrids_tpu --mode 9 --cpu
# --rows 24 --cols 24 --n-split 3 --levels 4 --ntime 2)
CLI_HISTORY = [0.28839, 0.077034]
# JAX package on CPU, f32: the bench-geometric configuration below,
# solver.residual(0, x, b, True) after each of 10 V-cycles from T0
BENCH_HISTORY = [1.3474e-01, 3.3982e-02, 2.3502e-02, 1.7760e-02, 1.4149e-02,
                 1.1972e-02, 1.0330e-02, 9.0518e-03, 8.0156e-03, 7.1683e-03]
# CLI arguments below leave out --device: the runs add it
CLI_ARGS = ["--mode", "9", "--rows", "24", "--cols", "24", "--n-split", "3",
            "--levels", "4", "--ntime", "2"]
GATE_ARGS = ["--mode", "9", "--rows", "24", "--cols", "24", "--n-split",
             "2", "--levels", "3", "--dt", "1e8", "--krylov", "--krylov-tol",
             "1e-6", "--ntime", "1"]
# the production solver (bench.py's amg section) through the CLI at
# 393,216 DOF: SA-corrected V-cycle preconditioning PCG to 1e-6
AMG_ARGS = ["--mode", "9", "--rows", "128", "--cols", "32", "--n-split", "2",
            "--levels", "1", "--amg", "--agg-strength", "0.5",
            "--cheb-degree", "16", "--cheb-lower", "0.05", "--dt", "0.05",
            "--krylov", "--krylov-tol", "1e-6", "--ntime", "2"]
# JAX package on CPU, f32, the same command with --cpu: residual_history
# and L1_error as it prints them; PCG iterations per step from
# p_a_multigrids_tpu.ops.krylov.pcg run on the same steps
AMG_CLI = {"residual_history": [5.6770317314658314e-05, 2.0109040633542463e-05],
           "L1_error": 0.13628384470939636, "krylov_iterations": [6, 4]}
# JAX package on CPU, f32 (python -m p_a_multigrids_tpu --mode 9 --cpu): the
# defaults, whose 9,600-DOF geometric coarsest continues into SA levels
DEFAULT_ARGS = ["--mode", "9"]
DEFAULT_HISTORY = [1.154605507850647, 0.4010283946990967]
# JAX package on CPU, f32: the amg configuration on the stand-in mesh
# (utils.profiling.amg_solver), max|b - A x| after each of 10 V-cycles from
# T0.  From cycle 7 on it sits on the f32 floor (4.2e-6 to 5.7e-6, the
# cycle-to-cycle ratio reaches 1), and cycle 6 is within 2x of it.
AMG_HISTORY = [7.6809e-03, 3.4141e-04, 1.0777e-04, 4.3869e-05, 1.9073e-05,
               8.1749e-06, 5.7173e-06, 4.2293e-06, 5.6080e-06, 4.2279e-06]
AMG_FLOOR = 5.7173e-06       # the largest of the floored cycles 7-10
AMG_PCG_ITERS = 5            # JAX package on CPU, f32, same solve
# K1 phases (= launches) and rounds in one cycle: bench-geometric,
# production amg, the level sweep's 6-level W-cycle (counted on the CPU by
# wrapping models.semi.phase)
CYCLE_K1 = {"bench": (3, 21), "amg": (4, 35), 6: (30, 195)}

# The deep-split path: bench.py's level sweep on its stand-in mesh
# (utils.profiling.sweep_solver: tri_mesh(8, 6, 1/8, 1/8), n_split 5, 96
# macros of C = 1024 children, 294,912 DOF; dt = 1e8, W-cycles, degree-6
# Chebyshev).  JAX package on CPU, f32: max|b - A x| after each of 10
# cycles from T0, by geometric levels.  Levels 2-4 continue into SA levels
# below the geometric coarsest, 5-6 end in the dense coarse solve.
SWEEP_HISTORY = {
    1: [2.8865e-01, 1.5550e-01, 1.1369e-01, 8.6897e-02, 7.0131e-02,
        6.0001e-02, 5.2024e-02, 4.5372e-02, 4.1201e-02, 3.7414e-02],
    2: [1.0632e-01, 2.3886e-02, 5.4143e-03, 1.2085e-03, 3.2552e-04,
        9.0915e-05, 2.7973e-05, 8.4020e-06, 4.0009e-06, 2.8117e-06],
    3: [1.0619e-01, 2.6008e-02, 6.5939e-03, 1.6635e-03, 4.1605e-04,
        1.1473e-04, 3.4618e-05, 1.0808e-05, 5.0627e-06, 2.9084e-06],
    4: [1.0512e-01, 2.6307e-02, 7.1375e-03, 2.0125e-03, 5.8771e-04,
        1.7572e-04, 5.4604e-05, 1.7885e-05, 6.9199e-06, 3.1783e-06],
    5: [1.0510e-01, 2.6289e-02, 7.1375e-03, 2.0211e-03, 5.9534e-04,
        1.8240e-04, 6.0326e-05, 1.9793e-05, 7.8736e-06, 4.1237e-06],
    6: [1.0496e-01, 2.6148e-02, 7.1271e-03, 2.0831e-03, 6.6972e-04,
        2.4248e-04, 1.0133e-04, 5.6562e-05, 3.3652e-05, 2.1254e-05],
}
# the same with coarse_operator="galerkin" at 4 levels
GALERKIN4_HISTORY = [1.0512e-01, 2.6306e-02, 7.1366e-03, 2.0125e-03,
                     5.8580e-04, 1.7667e-04, 5.4604e-05, 1.7885e-05,
                     6.9199e-06, 3.1784e-06]
# the sweep's production row (utils.profiling.deep_amg_solver: amg,
# agg_strength 0.5, degree-16 Chebyshev, V-cycles): 10 V-cycles from T0,
# and PCG iterations to 1e-6
DEEP_AMG_HISTORY = [1.2443e-02, 1.3240e-03, 2.5828e-04, 1.5814e-04,
                    9.2815e-05, 5.2765e-05, 3.0349e-05, 1.7951e-05,
                    1.0326e-05, 6.5072e-06]
DEEP_AMG_PCG_ITERS = 7
# The f32 floor of max|b - A x| on the stand-in: the largest value of
# cycles 16-25 over levels 2-6, Galerkin and amg, where every JAX history
# has stopped falling (2.2e-6 to 3.2e-6).  Between two summation orders
# the history moves by up to about half of it near the floor: the port's
# plain path on the CPU against JAX (both f32) moved by 1.2e-6, 17% of a
# value at 2x the floor and 4% at 9x.  So a deep history is held to 2% of
# the JAX value plus this floor.
SWEEP_FLOOR = 3.1763e-06
# The CLI with --mesh on a gmsh file of the stand-in (written by this
# script, every third macro region 4 so that T0 is not zero) at n_split 4:
# levels C = 256, 64, 16, the 4,608-DOF coarsest continuing into SA
# levels.  JAX package on CPU, f32, the same command with --cpu.
MESH_ARGS = ["--mode", "9", "--n-split", "4", "--levels", "3",
             "--ntime", "2"]
MESH_CLI = {"residual_history": [0.6321610808372498, 0.18055221438407898],
            "L1_error": 0.523080587387085}

# The other modes' paths (utils.profiling's MODE*_ARGS).  Mode 10 at
# 393,216 DOF: the assembled operator (131,072 x 4 blocks) through K2 once a
# sweep, 8 sweeps a step.  JAX package on CPU, f32, the same command with
# --cpu (20.7 s there): residual_history and L1_error as it prints them.
MODE10_CLI = {"residual_history": [0.86222904920578, 0.48487573862075806],
              "L1_error": 0.7695680260658264}
MODE10_SWEEPS = 8
# Mode 8 on 8 x 8 macros (6,144 DOF): JAX package on CPU, f32
MODE8_SMALL_ARGS = ["--mode", "8", "--rows", "8", "--cols", "8"]
MODE8_SMALL_CLI = {"L1_error": 0.7630233764648438,
                   "residual": 1.9651503562927246}
# mode 9 PCG to 1e-6 on the mode-8 defaults' steps, the direct solve's
# yardstick on the card
MODE8_PCG_ARGS = ["--mode", "9", "--krylov", "--krylov-tol", "1e-6"]
# Mode 7 (theta = 0) at 393,216 DOF, dt 5e-8, 10 steps: JAX on CPU, f32
MODE7_CLI = {"residual_history": [
    5.758621692657471, 4.4643402099609375, 3.499004364013672,
    2.7839393615722656, 2.2439422607421875, 1.8317527770996094,
    1.5264883041381836, 1.3619956970214844, 1.2211074829101562,
    1.1000633239746094], "L1_error": 0.7720001339912415}
# Mode 9 with advection (u = (1, 0.5)) and --krylov: BiCGStab to 1e-6 at
# dt 0.01, 221,184 DOF.  JAX on CPU, f32: the CLI's residual_history and
# L1_error, and p_a_multigrids_tpu.ops.krylov.bicgstab's iterations on the
# same steps
BICGSTAB_CLI = {"residual_history": [0.0004478998889680952,
                                     0.00010597167420201004],
                "L1_error": 0.4053930640220642, "krylov_iterations": [5, 4]}
# Mode 9 with Crank-Nicolson (--theta 0.5) on the geometric CLI path: JAX
# on CPU, f32
THETA_HISTORY = [2.6587281227111816, 2.079700231552124]
# Mode 6 on painted_mesh(64) against the port's plain path on the host CPU
# (the full width, 256 x 256, takes ~80 s there)
MODE6_SMALL_N = 64

# The solver menu, the non-stencil path and mode 1 (utils.profiling's
# REFERENCE9_ARGS, GS_ARGS, RICHARDSON_ARGS, NSPLIT7_ARGS, MODE1_ARGS).
# JAX package on CPU, f32: the same commands with --cpu, as they print.
# (a) the reference's active mode-9 configuration, 393,216 DOF
REFERENCE9_CLI = {"residual_history": [5.097284883959219e-06,
                                       5.099435838928912e-06],
                  "L1_error": 0.7736029028892517}
# (b) colored Gauss-Seidel (omega 0.5) and Richardson (omega 0.01) with
# surface terms on the geometric CLI path, 221,184 DOF
GS_CLI = {"residual_history": [0.2821063995361328, 0.08501909673213959],
          "L1_error": 0.7583239078521729}
RICHARDSON_CLI = {"residual_history": [0.6225383281707764,
                                       0.22281049191951752],
                  "L1_error": 0.7546142935752869}
# --solver direct against --solver jacobi, on the card, at a small size
DIRECT_SMALL_ARGS = ["--mode", "9", "--rows", "8", "--cols", "8",
                     "--omega", "0.5", "--ntime", "2"]
# (c) Chebyshev through the fused operator at n_split 7 (48.9 s there)
NSPLIT7_CLI = {"residual_history": [0.17043468356132507, 0.0470312163233757],
               "L1_error": 0.758652925491333}
# (e) mode 1: the same t_range at 200 x 1 (3.1 s) and 200 x 1024 (103 s)
MODE1_REF_ARGS = ["--mode", "1", "--rows", "200", "--cols", "1"]
MODE1_CLI = {"ntime": 714, "dt": 0.35,
             "t_range": [-0.047208886593580246, 1.0472097396850586]}
# The moving box's centre of mass moves by u*t and its mass stays: exact to
# 1e-15 in float64; in float32 on the CPU the JAX package ends 9.7e-7
# (centre) and 5.1e-7 (mass) off, the port 1.19e-6 and 4.8e-7 (714 steps
# of f32 rounding), so 5e-6 relative
MODE1_GATE = 5e-6
# steps of the width run held to the port's plain path on the CPU
MODE1_CPU_STEPS = 20
# The user-defined problem through the CLI (slice 7) on the bench stand-in,
# 393,216 DOF: these expressions build the built-in manufactured problem
# (source 2*k*sin(x+y) with k = 1, the zero initial condition of a mesh
# with no region 4), so each run must equal the built-in run bit for bit
USER_BASE = ["--mode", "9", "--rows", "128", "--cols", "32", "--n-split",
             "2", "--levels", "2"]
USER_EXPR = ["--ic", "0", "--bc", "sin(x+y)", "--source", "2*sin(x+y)",
             "--analytical", "sin(x+y)"]
USER_ARGS = USER_BASE + USER_EXPR
# a NaN initial condition by expression, on the geometric CLI path
NAN_IC = ["--ic", "sqrt(-1 - x)", "--debug"]


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke FAILED: {what}")


def say(tag: str, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def hold_history(name: str, got: list, want: list):
    """A deep history against the JAX f32 CPU one: within 2% of each JAX
    value plus the f32 floor (SWEEP_FLOOR)."""
    check(len(got) == len(want), f"{name}: {len(got)} cycles")
    for i, (g, w) in enumerate(zip(got, want)):
        check(math.isfinite(g) and abs(g - w) <= 0.02 * w + SWEEP_FLOOR,
              f"{name} cycle {i + 1}: {g:.4e} not within 2% + "
              f"{SWEEP_FLOOR:.2e} of {w:.4e}")


def history(solver, cycles: int = 10):
    """max|b - A x| after each of ``cycles`` cycles from T0."""
    from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t
    x_t = to_t(solver.initial_condition())
    b_t = solver._rhs_t(x_t)
    out = []
    for _ in range(cycles):
        x_t = solver._vcycle_t(0, x_t, b_t)
        r = solver.residual(0, from_t(x_t), from_t(b_t), True)
        out.append(float(r.abs().max()))
    return out


# The distributed solver (slice 8, phase 32) on the bench stand-in: the
# geometric configuration (bench.py's, with unpacked coarse levels, which
# the distributed solver requires and which give the same numbers) and the
# production amg one (utils.profiling.amg_solver's), each on 1 rank (nccl:
# one card), 2 and 4 ranks sharing the card (gloo, messages staged through
# host memory); at 2 ranks also n_split 4 (K1 at C = 256) on the level
# sweep's mesh, one deep-ghost chunk whose halo (49 macros) spans more than
# a rank's 48
DIST_STANDIN = [128, 32, 3 / 128, 1 / 128]
DIST_CONFIGS = {
    "geo": (DIST_STANDIN, dict(n_split=2, multi_levels=2, dt=0.05, ntime=1,
                               n_multigrid=1, coarse_agg=False,
                               coarse_cheb_degree=8, coarse_cheb_lower=0.02)),
    "amg": (DIST_STANDIN, dict(n_split=2, multi_levels=1, dt=0.05, ntime=1,
                               n_multigrid=1, amg=True, agg_strength=0.5,
                               cheb_degree=16, cheb_lower=0.05)),
    "deep": ([8, 6, 1 / 8, 1 / 8], dict(n_split=4, multi_levels=2, dt=1e8,
                                       ntime=1, n_multigrid=1,
                                       coarse_agg=False,
                                       dist_ghost_max_frac=1e9)),
}
DIST_WORLDS = {1: ("geo", "amg"), 2: ("geo", "amg", "deep"),
               4: ("geo", "amg")}
DIST_CYCLES = 10
DIST_STEPS = 5               # timed steps a configuration, after one more


def _dist_rank(comm, names, kernel_times):
    """One rank of phase 32: for each configuration in ``names``, the
    distributed solver's setup and ghost report; on the first and last
    ranks K1 on each level's extended operators and K2 on each sharded
    rowop against their plain versions; then the main path with every
    count at 0 (DIST_CYCLES cycles from T0 with the residual after each
    and, for amg, one PCG step to 1e-6), the counts; on rank 0 the serial
    twin on the card from the same state; and ms a step by CUDA events on
    rank 0 between barriers, with the host seconds of staging.  With
    ``kernel_times``, rank 0 also times the fine phase on its extended
    domain and the level-0 restriction partial product beside their plain
    versions, bounds and (K2) the library call, by CUDA events and by
    torch.profiler's device time."""
    import dataclasses

    import numpy as np
    import torch

    from p_a_multigrids_tpu_torch.config import SemiConfig
    from p_a_multigrids_tpu_torch.mesh import structured
    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops import spmv as K2
    from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t
    from p_a_multigrids_tpu_torch.parallel.stencil_solver import (
        DistributedStencilSolver)
    from p_a_multigrids_tpu_torch.utils.profiling import (
        bound_ms, bsr_matrix, event_ms, least_bytes, phase_profile,
        rowop_least_bytes, rowop_profile)

    dev = comm.device
    rng = np.random.default_rng(comm.rank)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    def gmax(t):
        """max |t| over every rank."""
        return float(comm.all_gather(t.abs().max()[None]).max())

    out = {}
    for name in names:
        mesh_args, cfg_kw = DIST_CONFIGS[name]
        cfg = SemiConfig(**cfg_kw)
        t0 = time.perf_counter()
        dist = DistributedStencilSolver(structured.tri_mesh(*mesh_args),
                                        cfg, comm)
        torch.cuda.synchronize()
        res = dict(setup_s=time.perf_counter() - t0,
                   ghost=dist.ghost_report(), parity=[])
        if comm.rank in (0, comm.world - 1):
            for li, ph in enumerate(dist._phases):
                coefs = dist._coefs[li][:ph.chunk]
                for tag, op, tier, want_z in (
                        ("fin", ph.op, ph.tier, True),
                        ("mid", ph.op_mid, ph.tier_mid, False)):
                    if op is None:
                        continue
                    x, bp = rand(3, op.C, op.U), rand(3, op.C, op.U)
                    got = K.phase_on_tier(op, x, bp, coefs, want_z, tier)
                    ref = K.phase_reference(op, x, bp, coefs, want_z)
                    err = max(float((g - r).abs().max())
                              for g, r in zip(got, ref) if r is not None)
                    scale = max(float(r.abs().max()) for r in ref
                                if r is not None)
                    res["parity"].append(dict(
                        kernel="k1", op=f"l{li}_{tag}", C=op.C, U=op.U,
                        rounds=len(coefs) + want_z,
                        tier=K.KERNEL.plan(op, tier).tier, err=err,
                        rel=err / scale))
            for rname, rop in dist.rowops().items():
                x = rand(3, rop.n_src)
                y, yr = rop(x), K2.rowop_reference(*rop.tables(), x)
                err = float((y - yr).abs().max())
                res["parity"].append(dict(
                    kernel="k2", op=rname, N=rop.n_out, D=rop.D,
                    S=rop.n_src, variant=rop.variant, err=err,
                    rel=err / float(yr.abs().max())))
        torch.cuda.synchronize()
        # the main path, its counts from 0
        comm.barrier()
        K.KERNEL.reset()
        K2.KERNEL.launches = 0
        T0 = dist.initial_condition()
        b = dist._rhs_t(T0)
        x, hist = T0, []
        for _ in range(DIST_CYCLES):
            x = dist._vcycle_t(0, x, b)
            hist.append(gmax(b - dist._apply_t(0, x, True)))
        if cfg.amg:
            dist.cfg = dataclasses.replace(cfg, krylov=True, krylov_tol=1e-6)
            T_pcg = dist.step(T0)
            dist.cfg = cfg
        torch.cuda.synchronize()
        res["counts"] = dict(k1=K.KERNEL.launches, k1_rounds=K.KERNEL.rounds,
                             k1_tiers={k: v for k, v in
                                       K.KERNEL.by_tier.items() if v},
                             k2=K2.KERNEL.launches)
        res["history"] = hist
        res["pcg_iters"] = list(dist.krylov_iters)
        x_full = comm.all_gather(x, -1)
        pcg_full = comm.all_gather(T_pcg, -1) if cfg.amg else None
        if comm.rank == 0:
            sv = dist.serial
            Tf = to_t(sv.initial_condition())
            bf = sv._rhs_t(Tf)
            xs, shist = Tf, []
            for _ in range(DIST_CYCLES):
                xs = sv._vcycle_t(0, xs, bf)
                shist.append(float(sv.residual(0, from_t(xs), from_t(bf),
                                               True).abs().max()))
            res["serial_history"] = shist
            res["bits_equal"] = bool(torch.equal(x_full, xs))
            res["max_abs_diff"] = float((x_full - xs).abs().max())
            if cfg.amg:
                sv.cfg = dataclasses.replace(cfg, krylov=True,
                                             krylov_tol=1e-6)
                Ts = sv._step_t(Tf)
                sv.cfg = cfg
                res["serial_pcg_iters"] = list(sv.krylov_iters)
                res["pcg_rel_diff"] = float((pcg_full - Ts).abs().max()
                                            / Ts.abs().max())
            torch.cuda.synchronize()
        # ms a step (the bare step), rank 0's CUDA events between barriers
        T = dist.step(T0)
        comm.barrier()
        torch.cuda.synchronize()
        comm.reset_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(DIST_STEPS):
            T = dist.step(T)
        end.record()
        torch.cuda.synchronize()
        res["host_s"] = (time.perf_counter() - t0) / DIST_STEPS
        comm.barrier()
        res["ms_step"] = start.elapsed_time(end) / DIST_STEPS
        res["stats"] = dict(comm.stats)
        res["staging_share"] = (comm.stats["staging_s"] * 1e3 / DIST_STEPS
                                / res["ms_step"])
        res["wait_share"] = (comm.stats["wait_s"] * 1e3 / DIST_STEPS
                             / res["ms_step"])
        if kernel_times and comm.rank == 0:
            res["kernel_times"] = kt = {}

            def pair(run_k, run_p, reps):
                """(kernel ms, plain ms) by CUDA events, in turns plain,
                kernel, kernel, plain after 3 warm-up calls of each."""
                for fn in (run_k, run_p):
                    for _ in range(3):
                        fn()
                t = {run_k: [], run_p: []}
                for fn in (run_p, run_k, run_k, run_p):
                    t[fn].append(event_ms(fn, reps))
                return sum(t[run_k]) / 2, sum(t[run_p]) / 2

            ph = dist._phases[0]
            op, coefs = ph.op, dist._coefs[0][:ph.chunk]
            x, bp = rand(3, op.C, op.U), rand(3, op.C, op.U)
            xr, zr = K.phase_reference(op, x, bp, coefs, True)
            xk, zk = K.phase_on_tier(op, x, bp, coefs, True, ph.tier)
            k_ms, p_ms = pair(
                lambda: K.phase_on_tier(op, x, bp, coefs, True, ph.tier),
                lambda: K.phase_reference(op, x, bp, coefs, True), 20)
            kt["k1"] = dict(
                C=op.C, U_ext=op.U, rounds=len(coefs) + 1,
                tier=K.KERNEL.plan(op, ph.tier).tier, ms=k_ms, plain_ms=p_ms,
                bound_ms=bound_ms(least_bytes(op)),
                err=max(float((xk - xr).abs().max()),
                        float((zk - zr).abs().max())),
                # torch.profiler's device time of the same launch
                device_us=phase_profile(op, len(coefs) + 1, tier=ph.tier)[
                    "device_us_per_phase"])
            rops = dist.rowops()
            if rops:
                rop = rops["l0_rc"]
                x = rand(3, rop.n_src)
                yr = K2.rowop_reference(*rop.tables(), x)
                k_ms, p_ms = pair(
                    lambda: rop(x),
                    lambda: K2.rowop_reference(*rop.tables(), x), 50)
                A, xv = bsr_matrix(rop), x.T.reshape(-1).contiguous()
                for _ in range(3):
                    A @ xv
                kt["k2"] = dict(
                    N=rop.n_out, D=rop.D, S=rop.n_src, variant=rop.variant,
                    ms=k_ms, plain_ms=p_ms,
                    least_MB=rowop_least_bytes(rop) / 1e6,
                    bound_ms=bound_ms(rowop_least_bytes(rop)),
                    library_ms=event_ms(lambda: A @ xv, 50),
                    err=float((rop(x) - yr).abs().max()),
                    scale=float(yr.abs().max()),
                    library_err=float(((A @ xv).reshape(rop.n_out, 3).T
                                       - yr).abs().max()))
                prof = rowop_profile(rop)
                kt["k2"].update(device_us=prof["device_us"],
                                library_device_us=prof["library_us"])
        comm.barrier()
        out[name] = res
        del dist
        torch.cuda.empty_cache()
    return out


def dist_phase(card: str):
    """Phase 32, the distributed solver (slice 8) on the bench stand-in: 1
    rank under nccl, 2 and 4 ranks sharing the card under gloo, one spawn a
    world size running every configuration of DIST_WORLDS (``_dist_rank``);
    then the CLI's --devices 2 on the card against CPU ranks.  Returns
    (rank 0's K1 and K2 launches in the 4-rank main path, its K1 and K2
    timings) for the kernels line."""
    import torch

    from p_a_multigrids_tpu_torch import __main__ as cli
    from p_a_multigrids_tpu_torch.parallel import comm as dcomm
    dist_res = {}
    for world, names in DIST_WORLDS.items():
        t0 = time.time()
        backend = dcomm.backend_for("cuda", world)
        check(backend == ("nccl" if world <= torch.cuda.device_count()
                          else "gloo"), f"{world} ranks: backend {backend}")
        dist_res[world] = res = dcomm.launch(
            _dist_rank, world, "cuda", args=(names, world == 4),
            timeout=600, pg_timeout=300, threads=max(1, 8 // world))
        say("dist", ranks=world, backend=backend, configs=list(names),
            seconds=f"{time.time() - t0:.1f}")
        for name in names:
            r0 = res[0][name]
            say("dist_setup", ranks=world, config=name,
                seconds=[f"{r[name]['setup_s']:.1f}" for r in res])
            for lv in r0["ghost"]:
                say("ghost", ranks=world, config=name, **lv)
            for rank in sorted({0, world - 1}):
                for p in res[rank][name]["parity"]:
                    say("parity", ranks=world, rank=rank, config=name,
                        **{k: (f"{v:.3e}" if isinstance(v, float) else v)
                           for k, v in p.items()})
                    tol = 1e-4 if p["kernel"] == "k1" else 1e-5
                    check(p["rel"] <= tol,
                          f"{world} ranks, rank {rank}, {name}: {p}")
            counts = [r[name]["counts"] for r in res]
            say("main", path=f"dist_{name}", ranks=world, launches=counts,
                history=[f"{v:.5e}" for v in r0["history"]],
                serial_history=[f"{v:.5e}" for v in r0["serial_history"]],
                bits_equal=r0["bits_equal"],
                max_abs_diff=f"{r0['max_abs_diff']:.3e}",
                pcg_iters=r0["pcg_iters"],
                serial_pcg_iters=r0.get("serial_pcg_iters"))
            check(all(c["k1"] > 0 for c in counts),
                  f"{world} ranks, {name}: a rank launched no K1: {counts}")
            if name == "amg":
                check(all(c["k2"] > 0 for c in counts),
                      f"{world} ranks, amg: a rank launched no K2: {counts}")
                check(abs(r0["pcg_iters"][0] - r0["serial_pcg_iters"][0])
                      <= 1, f"{world} ranks: PCG {r0['pcg_iters']} "
                      f"iterations, serial {r0['serial_pcg_iters']}")
                check(r0["pcg_rel_diff"] <= 1e-4,
                      f"{world} ranks: PCG step {r0['pcg_rel_diff']:.3e} "
                      "from the serial one")
            if name != "amg" or world == 1:
                # the same arithmetic as the serial solver: bit for bit
                check(r0["bits_equal"] and r0["history"]
                      == r0["serial_history"],
                      f"{world} ranks, {name}: {DIST_CYCLES} cycles differ "
                      f"from the serial solver by {r0['max_abs_diff']:.3e}")
            else:
                # the sharded SA restriction sums in another order; where
                # the floor is the larger term a cycle is held to the band
                # alone (the PCG checks above hold the converged end)
                # rel_distance is what the cycles measured, band_width
                # what the check allows (2% + the floor, relative)
                say("band", ranks=world, config=name,
                    cycles_held_by_2pc=[
                        i + 1 for i, w in enumerate(r0["serial_history"])
                        if 0.02 * w > AMG_FLOOR],
                    cycles_held_by_floor=[
                        i + 1 for i, w in enumerate(r0["serial_history"])
                        if 0.02 * w <= AMG_FLOOR],
                    rel_distance=[f"{abs(g - w) / w:.4f}" for g, w in zip(
                        r0["history"], r0["serial_history"])],
                    band_width=[f"{0.02 + AMG_FLOOR / w:.4f}"
                                for w in r0["serial_history"]])
                for i, (g, w) in enumerate(zip(r0["history"],
                                               r0["serial_history"])):
                    check(math.isfinite(g)
                          and abs(g - w) <= 0.02 * w + AMG_FLOOR,
                          f"{world} ranks, amg cycle {i + 1}: {g:.4e} not "
                          f"within 2% + {AMG_FLOOR:.2e} of {w:.4e}")
            say("time", path=f"dist_{name}", ranks=world,
                ms_step=f"{r0['ms_step']:.3f}",
                host_ms_step=f"{1e3 * r0['host_s']:.3f}",
                staging_share=f"{r0['staging_share']:.3f}",
                wait_share=f"{r0['wait_share']:.3f}",
                messages=r0["stats"]["messages"], bytes=r0["stats"]["bytes"],
                note="ranks share one card: host and staging cost, not "
                     "scaling", card=repr(card))
    deep = dist_res[2][0]["deep"]["ghost"]
    check(all(lv["He"] > lv["U_loc"] for lv in deep),
          f"deep split: no multi-hop halo {deep}")
    kt1 = dist_res[4][0]["geo"]["kernel_times"]["k1"]
    kt2 = dist_res[4][0]["amg"]["kernel_times"]["k2"]
    say("time", kernel="k1_phase_dist", card=repr(card),
        **{k: (f"{v:.5f}" if isinstance(v, float) else v)
           for k, v in kt1.items()})
    say("time", kernel="k2_rowop_dist", op="l0_rc", card=repr(card),
        **{k: (f"{v:.5f}" if isinstance(v, float) else v)
           for k, v in kt2.items()})
    check(kt2["library_err"] <= 1e-5 * kt2["scale"],
          f"l0_rc: the BSR yardstick differs by {kt2['library_err']:.3e}")
    dist_k1_launches = sum(dist_res[4][0][n]["counts"]["k1"]
                           for n in DIST_WORLDS[4])
    dist_k2_launches = dist_res[4][0]["amg"]["counts"]["k2"]
    # (d) the CLI: --devices 2 on the card against the same on CPU ranks
    g_out = cli.main(CLI_ARGS + ["--devices", "2"])
    c_out = cli.main(CLI_ARGS + ["--devices", "2", "--device", "cpu"])
    say("main", path="dist_cli", cuda=g_out, cpu=c_out)
    check(set(g_out) == set(c_out) == {"mode", "devices", "elements",
                                       "children", "L1_error", "wall_s"},
          f"--devices keys {sorted(g_out)}")
    check(abs(g_out["L1_error"] - c_out["L1_error"])
          <= 1e-4 * abs(c_out["L1_error"]),
          f"--devices 2: L1 {g_out['L1_error']} on the card, "
          f"{c_out['L1_error']} on the CPU")
    return dist_k1_launches, dist_k2_launches, kt1, kt2


# Phase 33 (slice 9): the C++ mesh loaders on the GPU host, built with c++
# at first use, on painted_mesh(MODE6_N) written as a gmsh file; the mode-6
# CLI on it, beside its wall_s with the Python loaders (6.719 s, phase 20's
# line in the last run before the C++ loaders, H100 80GB HBM3, 700 W);
# --profile DIR over the production amg CLI run; SemiSolver.solve_system
# against the CLI step's Krylov solve
MODE6_CLI_WALL_PY_LOADERS = 6.719


def native_profile_phase(card: str):
    """Phase 33: (a) the native loaders against the Python paths, bit for
    bit, with the seconds of each, and the mode-6 CLI on their file; (b) the
    production amg CLI with --profile DIR, its counts from 0: the trace's
    K1 and K2 kernels equal the wrappers' counts, and its history and
    Krylov counts equal the same run without the trace, bit for bit; (c)
    solve_system on that solver equals its CLI step's Krylov solve bit for
    bit, through K1 and K2."""
    import numpy as np
    import torch

    from p_a_multigrids_tpu_torch import __main__ as cli
    from p_a_multigrids_tpu_torch.mesh import gmsh, topology
    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops import spmv as K2
    from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t
    from p_a_multigrids_tpu_torch.utils import native
    from p_a_multigrids_tpu_torch.utils.profiling import (
        MODE6_ARGS, MODE6_N, _missing_launches, kernel_class, painted_mesh,
        trace_kernels)

    def counts_zero():
        K.KERNEL.reset()
        K2.KERNEL.launches = 0

    def read_counts():
        return {"k1_phase": K.KERNEL.launches, "k2_rowop": K2.KERNEL.launches}

    def same(a, b):
        return a.dtype == b.dtype and np.array_equal(a, b)

    # (a) the loaders (built with c++ at first use: step 2 of main) -------
    check(native.available(), "the native loaders are not available")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/painted_{MODE6_N}.msh"
        gmsh.write_msh(path, painted_mesh(MODE6_N))
        t0 = time.perf_counter()
        v, t, r = native.read_msh(path)
        read_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = gmsh._read_msh_py(path)
        read_py = time.perf_counter() - t0
        check(same(v, raw.vertices) and same(t, raw.triangles)
              and same(r, raw.region_id),
              "the C++ reader differs from the Python parser")
        tri, _ = topology.dedupe_vertices(raw.vertices, raw.triangles)
        t0 = time.perf_counter()
        topo_n = native.neighbor_topology(tri)
        topo_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        topo_p = topology._neighbor_topology_py(tri)
        topo_py = time.perf_counter() - t0
        check(all(same(a, b) for a, b in zip(topo_n, topo_p)),
              "the C++ neighbor search differs from the Python one")
        # the mode-6 CLI's mesh (its setup's part the loaders take)
        t0 = time.perf_counter()
        topology.from_msh(path)
        load_s = time.perf_counter() - t0
        say("native", mesh=f"painted_mesh({MODE6_N})", elements=len(tri),
            file_MB=f"{os.path.getsize(path) / 1e6:.1f}",
            read_native_s=f"{read_native:.4f}", read_py_s=f"{read_py:.4f}",
            topology_native_s=f"{topo_native:.4f}",
            topology_py_s=f"{topo_py:.4f}", bits_equal=True, card=repr(card))
        m6_out = cli.main(MODE6_ARGS + ["--mesh", path, "--device", "cuda"])
        say("setup", config="mode6_cli", mesh_load_s=f"{load_s:.4f}",
            python_loaders_s=f"{read_py + topo_py:.4f}",
            wall_s=m6_out["wall_s"],
            wall_s_python_loaders=MODE6_CLI_WALL_PY_LOADERS,
            card=repr(card))
        check(m6_out["elements"] == 131072, f"mode 6 CLI: {m6_out}")

        # (b) --profile over the production amg CLI, its counts from 0 ---
        argv = AMG_ARGS + ["--device", "cuda"]
        counts_zero()
        t0 = time.perf_counter()
        plain, T_plain, sv = cli.run(argv)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_counts = read_counts()
        logdir = f"{tmp}/profile"
        counts_zero()
        t0 = time.perf_counter()
        prof, T_prof, _ = cli.run(argv + ["--profile", logdir])
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
        prof_counts = read_counts()
        trace_path = f"{logdir}/trace.json"
        check(os.path.isfile(trace_path), f"no trace at {trace_path}")
        kernels = trace_kernels(trace_path)
        traced = {cls: sum(1 for n, _, _ in kernels if kernel_class(n) == cls)
                  for cls in prof_counts}
        say("main", path="profile_amg_cli", launches=prof_counts,
            traced=traced, trace_kernels=len(kernels),
            trace_MB=f"{os.path.getsize(trace_path) / 1e6:.1f}",
            residual_history=prof["residual_history"],
            krylov_iterations=prof["krylov_iterations"],
            profile_dir=prof.get("profile_dir"), card=repr(card))
        check(prof_counts["k1_phase"] > 0 and prof_counts["k2_rowop"] > 0,
              f"the profiled amg path did not launch both kernels: "
              f"{prof_counts}")
        missing = _missing_launches(kernels, prof_counts)
        check(missing is None, f"--profile trace: {missing}")
        check(prof.get("profile_dir") == logdir, "no profile_dir key")
        check(prof["residual_history"] == plain["residual_history"]
              and prof["krylov_iterations"] == plain["krylov_iterations"]
              and bool(torch.equal(T_prof, T_plain))
              and prof_counts == plain_counts,
              f"--profile changed the run: {prof} against {plain}")
        say("time", path="profile_amg_cli", wall_s_traced=f"{prof_s:.3f}",
            wall_s_untraced=f"{plain_s:.3f}",
            cli_wall_s=[prof["wall_s"], plain["wall_s"]], card=repr(card))

    # (c) solve_system against the CLI step's Krylov solve ----------------
    T0 = sv.initial_condition()
    T0_t = to_t(T0)
    b_t = sv._rhs_t(T0_t)
    sv.krylov_iters.clear()
    counts_zero()
    x_step = sv._step_t(T0_t)
    torch.cuda.synchronize()
    step_counts, step_iters = read_counts(), list(sv.krylov_iters)
    counts_zero()
    x_api = sv.solve_system(from_t(b_t), T0)
    torch.cuda.synchronize()
    api_counts, api_iters = read_counts(), sv.krylov_iters[len(step_iters):]
    say("main", path="solve_system", launches=api_counts,
        step_launches=step_counts, krylov_iterations=api_iters,
        step_krylov_iterations=step_iters,
        cli_krylov_iterations=plain["krylov_iterations"],
        bits_equal=bool(torch.equal(to_t(x_api), x_step)))
    check(api_counts["k1_phase"] > 0 and api_counts["k2_rowop"] > 0,
          f"solve_system did not launch both kernels: {api_counts}")
    check(bool(torch.equal(to_t(x_api), x_step)) and api_iters == step_iters
          and step_iters[0] == plain["krylov_iterations"][0],
          "solve_system differs from the CLI step's Krylov solve")


# Phase 34 (slice 10): the entry points that take a device land on the card
# when given none, and the JAX package's last three public names run there.
# BSR.to_dense is held at 1,024 block rows (3,072 rows, a 38 MB dense
# matrix): mode 10's 131,072-block operator would be a 600 GB one.
API_BSR_MESH = (32, 16)      # tri_mesh(32, 16): 1,024 triangles
API_SWEEPS = 3


def api_phase(card: str):
    """Phase 34: (a) transport_rect.solve(cfg, ntime=3) with no device runs
    on cuda and equals the explicit-device run bit for bit, at mode 1's
    width (200 x 1024); FusedOperator without a device holds its buffers on
    cuda and applies A as the explicit-device one does, bit for bit; (b)
    smoothers.block_jacobi_inv on the bench stand-in's fine level, apply_A
    the zero-round K1 apply and inv_blocks the exact inverses of its 3x3
    diagonal blocks: three sweeps in exactly three K1 launches, equal bit
    for bit to block_jacobi_solve with the same inverse, and within 1e-4 of
    the same sweeps over the plain PyTorch apply; (c) BSR.to_dense on the
    card equals to_dense_numpy bit for bit on a 3,072-row operator, and
    StencilOperator.lam_max_estimate equals the module function bit for
    bit."""
    import numpy as np
    import torch

    from p_a_multigrids_tpu_torch.config import RectConfig
    from p_a_multigrids_tpu_torch.mesh import structured
    from p_a_multigrids_tpu_torch.models import transport_rect
    from p_a_multigrids_tpu_torch.ops import bsr, smoothers, stencil
    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops import spmv as K2
    from p_a_multigrids_tpu_torch.ops.fused import FusedOperator, from_t, to_t
    from p_a_multigrids_tpu_torch.utils.profiling import (bench_solver,
                                                          event_ms)

    def counts_zero():
        K.KERNEL.reset()
        K2.KERNEL.launches = 0

    def read_counts():
        return {"k1_phase": K.KERNEL.launches, "k2_rowop": K2.KERNEL.launches}

    # (a) no device: the card ------------------------------------------------
    cfg = RectConfig(no_ele_row=200, no_ele_col=1024)
    t0 = time.perf_counter()
    p_def, T_def, _, n_def = transport_rect.solve(cfg, ntime=3)
    torch.cuda.synchronize()
    def_s = time.perf_counter() - t0
    T_exp = transport_rect.solve(cfg, "cuda", ntime=3)[1]
    places = sorted({t.device.type for t in p_def.tables.values()}
                    | {T_def.device.type})
    sv = bench_solver(torch.device("cuda"))
    sc = sv.cfg
    L0 = sv.p.levels[0]
    fop = FusedOperator(L0, sc.physics, sc.dt, sc.theta)
    fop_exp = FusedOperator(L0, sc.physics, sc.dt, sc.theta, "cuda")
    fused_places = sorted({b.device.type for b in fop.buffers()})
    x_t = torch.as_tensor(
        np.random.default_rng(34).normal(size=(3, sv.ops[0].C, sv.ops[0].U)),
        dtype=torch.float32, device="cuda")
    fused_same = bool(torch.equal(fop.apply(x_t, True),
                                  fop_exp.apply(x_t, True)))
    say("main", path="default_device", mode1_on=places, steps=n_def,
        mode1_dof=T_def.numel(), bits_equal=bool(torch.equal(T_def, T_exp)),
        fused_on=fused_places, fused_bits_equal=fused_same,
        mode1_wall_s=f"{def_s:.4f}", card=repr(card))
    check(places == ["cuda"] and n_def == 3
          and bool(torch.equal(T_def, T_exp)),
          f"transport_rect.solve without a device: {places}, {n_def} steps")
    check(fused_places == ["cuda"] and fused_same,
          f"FusedOperator without a device: {fused_places}, bits equal "
          f"{fused_same}")
    del p_def, T_def, T_exp, fop, fop_exp

    # (b) block_jacobi_inv over the zero-round K1 apply ---------------------
    op = sv.ops[0]
    inv = torch.linalg.inv(op.S_t.permute(3, 2, 0, 1).contiguous())
    T0 = sv.initial_condition()
    b = from_t(sv._rhs_t(to_t(T0)))

    def k1_apply(v):
        return from_t(sv._apply_t(0, to_t(v)))

    def plain_apply(v):
        return from_t(op.apply(to_t(v), False))

    counts_zero()
    x_inv = smoothers.block_jacobi_inv(k1_apply, b, T0, inv,
                                       sweeps=API_SWEEPS)
    torch.cuda.synchronize()
    inv_counts = read_counts()
    x_solve = smoothers.block_jacobi_solve(
        k1_apply, b, T0, lambda r: torch.einsum("...ij,...j->...i", inv, r),
        sweeps=API_SWEEPS)
    x_plain = smoothers.block_jacobi_inv(plain_apply, b, T0, inv,
                                         sweeps=API_SWEEPS)
    err = float((x_inv - x_plain).abs().max())
    scale = float(x_plain.abs().max())
    ms = event_ms(lambda: smoothers.block_jacobi_inv(
        k1_apply, b, T0, inv, sweeps=API_SWEEPS), 10)
    plain_ms = event_ms(lambda: smoothers.block_jacobi_inv(
        plain_apply, b, T0, inv, sweeps=API_SWEEPS), 10)
    same = bool(torch.equal(x_inv, x_solve))
    say("main", path="block_jacobi_inv", dof=T0.numel(), sweeps=API_SWEEPS,
        launches=inv_counts, bits_equal_solve=same,
        max_abs_err_plain=f"{err:.3e}", max_abs=f"{scale:.4e}",
        finite=bool(torch.isfinite(x_inv).all()), card=repr(card))
    say("time", path="block_jacobi_inv", ms=f"{ms:.5f}",
        plain_ms=f"{plain_ms:.5f}", card=repr(card))
    check(inv_counts == {"k1_phase": API_SWEEPS, "k2_rowop": 0},
          f"block_jacobi_inv launched {inv_counts}")
    check(same, "block_jacobi_inv differs from block_jacobi_solve")
    check(bool(torch.isfinite(x_inv).all()) and err <= 1e-4 * scale,
          f"block_jacobi_inv: {err:.3e} from the plain apply")

    # (c) BSR.to_dense and StencilOperator.lam_max_estimate ------------------
    rng = np.random.default_rng(34)
    neig = structured.tri_mesh(*API_BSR_MESH, 1 / API_BSR_MESH[0],
                               1 / API_BSR_MESH[1]).neig
    E = neig.shape[0]
    A = bsr.build(rng.normal(size=(E, 3, 3)).astype(np.float32),
                  rng.normal(size=(E, 3, 3, 3)).astype(np.float32), neig)
    counts_zero()
    t0 = time.perf_counter()
    dense = A.to_dense()
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    dense_counts = read_counts()
    want = bsr.to_dense_numpy(A)
    dense_same = (dense.device.type == "cuda" and dense.dtype == torch.float32
                  and np.array_equal(dense.cpu().numpy(), want))
    t0 = time.perf_counter()
    lam = op.lam_max_estimate()
    lam_s = time.perf_counter() - t0
    lam_fn = stencil.lam_max_estimate(op._data)
    say("main", path="to_dense_lam_max", rows=3 * E,
        dense_on=dense.device.type, dense_bits_equal=dense_same,
        dense_launches=dense_counts, dense_s=f"{dense_s:.4f}",
        lam_max=lam, lam_max_function=lam_fn, lam_s=f"{lam_s:.3f}",
        card=repr(card))
    check(3 * E <= 3072 and dense_same,
          "BSR.to_dense on the card differs from to_dense_numpy")
    check(lam == lam_fn and math.isfinite(lam),
          f"lam_max_estimate {lam} against {lam_fn}")


# Phase 35 (slice 11): float64 on the card.  Every path runs kernels K1 and
# K2 in double: (a) the bench stand-in (the geometric configuration, its
# fine level in K1's streaming tier, and the bench:s2:l2 pin's solver), (b)
# the annulus CLI (pin annulus_geo:s3:cli), the production amg CLI and the
# PCG gate, (c) one W-cycle of the level sweep at 6 levels (C = 1024), each
# of its phases held to phase_reference, (d) mode 6 at 256 x 256 and (e)
# mode 10.  K1 is held to phase_reference within F64_K1_RTOL of the
# largest |output| (float32's 1e-4 for sums of ~40 terms in another order,
# compounded over up to 17 rounds, scaled by 2^-53 / 2^-24 is ~2e-13), K2
# to rowop_reference within F64_K2_RTOL of the largest |y|.
F64_K1_RTOL = 1e-11
F64_K2_RTOL = 1e-12
# Host-CPU float64 references of the same commands with --f64: the JAX
# package (python -m p_a_multigrids_tpu ... --cpu --f64: residual_history
# and L1_error as it prints them) and the port's plain path (--device cpu
# --f64: krylov_iterations).  The PCG gate's L1 is 5.13e-6 in both
# packages.
F64_GATE = {"L1_error": 5.132632683954287e-06, "krylov_iterations": [7]}
F64_AMG_CLI = {"residual_history": [5.390337523148096e-05,
                                    1.393946998348345e-05],
               "L1_error": 0.1368395671694575, "krylov_iterations": [5, 4]}
F64_ANNULUS_CLI = {"residual_history": [0.3923203566060553,
                                        0.13198252984595443],
                   "L1_error": 0.5644250344646894,
                   "krylov_iterations": [7, 6]}
F64_MODE10_CLI = {"residual_history": [0.8622281629539676,
                                       0.4848760015803071],
                  "L1_error": 0.769568097216069}
# A float64 CLI result against its host reference: the mode-10 history and
# L1 (no Krylov stop) to 1e-9 relative; the L1 of an iterate where PCG
# stopped (a 1e-6 or 1e-8 drop) to 1e-7, since two summation orders move
# that iterate (the gate's L1 on the H100 and on the host CPU: 1.05e-9
# apart), and its Krylov count within one.  The
# production amg CLI's SA setup depends on the host's BLAS thread count:
# its f64 L1 is 0.13684553896 with 1 or 8 OpenBLAS threads and
# 0.13683956715 with 4 (the port, --device cpu --f64, on an x86 host with
# OpenBLAS 0.3.27), 4.4e-5 apart,
# so its L1 is held to 1e-4.
F64_CLI_REL = 1e-9
F64_KRYLOV_REL = 1e-7
F64_SA_REL = 1e-4
# (f): every mode and the CLI's options at small sizes ({tmp}: a directory
# of the run), each in float32 and in float64 on the card; --devices 2
# against CPU ranks; the distributed solver at 2 ranks (tests'
# DIST_CASE's configuration)
F64_CLI_MATRIX = (
    [["--mode", "1", "--rows", "40", "--cols", "8"]]
    + [["--mode", str(m), "--rows", "8", "--cols", "8", "--ic", "x*y",
        "--ntime", "2"] for m in (2, 3, 4, 5, 6)]
    + [["--mode", "7", "--rows", "8", "--cols", "8", "--n-split", "2",
        "--dt", "5e-8", "--ntime", "2"],
       ["--mode", "8", "--rows", "8", "--cols", "8"],
       ["--mode", "9", "--rows", "8", "--cols", "8", "--ntime", "2"],
       ["--mode", "9", "--rows", "8", "--cols", "8", "--levels", "1",
        "--amg", "--krylov"],
       ["--mode", "9", "--rows", "8", "--cols", "8", "--krylov", "--u", "1",
        "0", "--dt", "0.01"],
       ["--mode", "9", "--rows", "8", "--cols", "8", "--theta", "0.5"],
       ["--mode", "9", "--rows", "1", "--cols", "1", "--n-split", "7",
        "--levels", "2", "--ntime", "1"],
       ["--mode", "9", "--rows", "8", "--cols", "8", "--levels", "1",
        "--amg", "--krylov", "--debug"],
       ["--mode", "9", "--rows", "8", "--cols", "8", "--levels", "1",
        "--amg", "--krylov", "--profile", "{tmp}/prof"],
       ["--mode", "10", "--rows", "8", "--cols", "8", "--n-split", "2",
        "--ntime", "2"]]
    + [["--mode", "9", "--rows", "8", "--cols", "8", "--solver", s,
        "--omega", w] for s, w in (("jacobi", "0.8"),
                                   ("gauss_seidel", "0.5"),
                                   ("richardson", "0.01"),
                                   ("direct", "0.8"))])
F64_DIST_ARGS = ["--mode", "9", "--rows", "4", "--cols", "4", "--ntime", "2",
                 "--devices", "2"]
F64_DIST_CASE = dict(kind="stencil", mesh=[16, 4, 0.25, 0.25],
                     cfg=dict(n_split=2, multi_levels=2, dt=0.05, ntime=2,
                              n_multigrid=2), ntime=2, serial=True)


def unit_counts(sv) -> dict:
    """K1 and K2 launches and K1 rounds of one operator apply and one
    homogeneous preconditioning cycle of sv (a PCG iteration's kernels,
    half a BiCGStab iteration's), from T0's right-hand side."""
    import torch

    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops import spmv as K2
    from p_a_multigrids_tpu_torch.ops.fused import to_t

    def now():
        return {"k1_phase": K.KERNEL.launches, "k1_rounds": K.KERNEL.rounds,
                "k1_deep": K.KERNEL.launches_deep,
                "k2_rowop": K2.KERNEL.launches}

    b_t = sv._rhs_t(to_t(sv.initial_condition()))
    before = now()
    sv._apply_t(0, b_t, False)
    sv._vcycle_t(0, torch.zeros_like(b_t), b_t, hom=True)
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in now().items()}


def krylov_drop(sv) -> tuple:
    """The first step's Krylov solve of sv from T0 as the step runs it
    (``_solve_system_t``'s system, method, stop and iteration cap):
    (iterations, the smallest residual 2-norm over the right-hand side's,
    which the stop compares with cfg.krylov_tol)."""
    import torch

    from p_a_multigrids_tpu_torch.ops import krylov
    from p_a_multigrids_tpu_torch.ops.fused import to_t

    cfg = sv.cfg
    T_t = to_t(sv.initial_condition())
    b_t = sv._rhs_t(T_t)
    b_lin = b_t - sv._apply_t(0, torch.zeros_like(b_t), True)
    method = krylov.bicgstab if cfg.physics.advection else krylov.pcg
    _, it, rn = method(lambda v: sv._apply_t(0, v, False), b_lin, T_t,
                       precond=lambda r: sv._vcycle_t(
                           0, torch.zeros_like(r), r, hom=True),
                       tol=cfg.krylov_tol, maxiter=cfg.krylov_maxiter)
    return it, float(rn) / float(torch.linalg.vector_norm(b_lin))


def f64_phase(card: str, f32: dict) -> list:
    """Phase 35: float64 on every path of the card, through the entry
    points a user calls (the CLI, SemiSolver, the profiling helpers' solver
    builders).  Each path's K1 / K2 launches and K1 rounds equal the f32
    run's on the same path (``f32``: counts from the earlier phases); where
    a Krylov solve stops after another number of iterations, the counts
    differ by that many iterations' kernels (``unit_counts``), and by
    nothing else.  Only K1's tier may differ (one launch a phase either
    way).  Returns the kernels line's float64 entries."""
    import numpy as np
    import torch

    from p_a_multigrids_tpu_torch import __main__ as cli
    from p_a_multigrids_tpu_torch.mesh import gmsh
    from p_a_multigrids_tpu_torch.models import semi
    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops import spmv as K2
    from p_a_multigrids_tpu_torch.ops import stencil
    from p_a_multigrids_tpu_torch.ops.fused import to_t
    from p_a_multigrids_tpu_torch.utils import debugging
    from p_a_multigrids_tpu_torch.utils.profiling import (
        MODE6_ARGS, MODE6_N, MODE10_ARGS, _trace, bench_solver, bound_ms,
        bsr_matrix, event_ms, kernel_class, least_bytes, painted_mesh,
        rowop_least_bytes, stencil_bsr_matrix, sweep_solver, trace_kernels,
        vcycle_profile, window_profile)
    from p_a_multigrids_tpu_torch.validation import history as pins_mod

    dev = torch.device("cuda", 0)
    f64 = torch.float64
    rng = np.random.default_rng(35)
    pins = pins_mod.load_pins()
    t_phase = time.perf_counter()
    count_keys = ("k1_phase", "k1_rounds", "k1_deep", "k2_rowop")
    # the worst |kernel - plain| by kernel entry, and the launches of the
    # main runs below by K1 tier and of K2
    errs = dict.fromkeys(("small", "resident", "stream", "apply", "k2"), 0.0)
    main_launches = {"k1_tiers": dict.fromkeys(K.TIERS, 0), "k2_rowop": 0,
                     "apply": 0}

    def counts_zero():
        K.KERNEL.reset()
        K.CHECKED.reset()
        K2.KERNEL.launches = K2.CHECKED.launches = 0

    def read_counts():
        return {"k1_phase": K.KERNEL.launches, "k1_rounds": K.KERNEL.rounds,
                "k1_deep": K.KERNEL.launches_deep,
                "k1_tiers": {k: v for k, v in K.KERNEL.by_tier.items() if v},
                "k2_rowop": K2.KERNEL.launches,
                "k1_checked": K.CHECKED.launches,
                "k2_checked": K2.CHECKED.launches}

    def main_run(path, fn):
        """fn() as one of this phase's main runs: counts set to 0 just
        before, read just after; a run that launches no kernel or a
        checked one fails."""
        counts_zero()
        out = fn()
        torch.cuda.synchronize()
        c = read_counts()
        check(c["k1_phase"] + c["k2_rowop"] > 0
              and c["k1_checked"] + c["k2_checked"] == 0,
              f"f64 {path}: launches {c}")
        for t, n in c["k1_tiers"].items():
            main_launches["k1_tiers"][t] += n
        main_launches["k2_rowop"] += c["k2_rowop"]
        return out, c

    def same_counts(path, c64, c32, its64=(), its32=(), unit=None,
                    per_iteration=1):
        """c64 == c32 on count_keys, apart from (sum(its64) - sum(its32))
        Krylov iterations of per_iteration x ``unit`` kernels each."""
        extra = (sum(its64) - sum(its32)) * per_iteration
        want = {k: c32[k] + (extra * unit[k] if unit else 0)
                for k in count_keys}
        got = {k: c64[k] for k in count_keys}
        say("launches", path=path, f64=got, f32={k: c32[k]
                                                 for k in count_keys},
            f64_tiers=c64["k1_tiers"], f32_tiers=c32.get("k1_tiers"),
            krylov_f64=list(its64), krylov_f32=list(its32),
            iteration_kernels=unit)
        check(got == want, f"f64 {path}: launches {got}, the f32 run's "
              f"{c32} with {extra} more Krylov iterations gives {want}")

    def rand(shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=f64, device=dev)

    def k1_parity(name, op, x, bp, coefs, want_z, tier=None, entry=None):
        """One float64 K1 launch (in ``tier`` when given) against
        phase_reference, and the checked build's bits against it."""
        n0 = K.KERNEL.launches
        xk, zk = K.phase_on_tier(op, x, bp, coefs, want_z, tier)
        torch.cuda.synchronize()
        used = K.KERNEL.plan(op, tier).tier
        check(K.KERNEL.launches - n0 == 1, f"f64 {name}: "
              f"{K.KERNEL.launches - n0} launches")
        xr, zr = K.phase_reference(op, x, bp, coefs, want_z)
        pairs = [("x", xk, xr)] + ([("z", zk, zr)] if want_z else [])
        for which, got, ref in pairs:
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            key = entry or used
            errs[key] = max(errs[key], err)
            say("parity", phase=35, case=name, out=which, dtype="float64",
                C=op.C, U=op.U, tier=used, rounds=len(coefs) + int(want_z),
                max_abs_err=f"{err:.3e}", max_ref=f"{scale:.3e}",
                rel=f"{err / scale:.3e}", tol=F64_K1_RTOL)
            check(got.dtype == f64 and bool(torch.isfinite(got).all()),
                  f"f64 {name} {which}: {got.dtype}, finite "
                  f"{bool(torch.isfinite(got).all())}")
            check(err <= F64_K1_RTOL * scale, f"f64 {name} {which}: "
                  f"|K1 - plain| {err:.3e} > {F64_K1_RTOL} * {scale:.3e}")
        san = debugging.Sanitizer(dev)
        op.sanitizer = san.site(f"f64 {name}", op.U)
        c0 = K.CHECKED.launches
        xc, zc = K.phase_on_tier(op, x, bp, coefs, want_z, tier)
        torch.cuda.synchronize()
        op.sanitizer = None
        san.raise_on_fault()
        check(K.CHECKED.launches - c0 == 1 and torch.equal(xc, xk)
              and (not want_z or torch.equal(zc, zk)),
              f"f64 {name}: the checked K1 build differs from the unchecked")
        return used

    def k2_parity(name, op):
        """One float64 K2 launch against rowop_reference, and the checked
        build's bits against it; returns the variant."""
        x = rand((3, op.n_src))
        n0 = K2.KERNEL.launches
        y = op(x)
        torch.cuda.synchronize()
        check(K2.KERNEL.launches - n0 == 1, f"f64 {name}: K2 launches")
        ref = K2.rowop_reference(*op.tables(), x)
        err = float((y - ref).abs().max())
        scale = float(ref.abs().max())
        errs["k2"] = max(errs["k2"], err)
        san = debugging.Sanitizer(dev)
        op.sanitizer = san.site(f"f64 {name}", 0)
        yc = op(x)
        torch.cuda.synchronize()
        op.sanitizer = None
        san.raise_on_fault()
        say("parity", phase=35, kernel="k2", case=name, dtype="float64",
            N=op.n_out, D=op.D, S=op.n_src, variant=op.variant,
            lanes=op.lanes, max_abs_err=f"{err:.3e}", max_ref=f"{scale:.3e}",
            tol=F64_K2_RTOL, checked_bits_equal=bool(torch.equal(yc, y)))
        check(y.dtype == f64 and bool(torch.isfinite(y).all())
              and err <= F64_K2_RTOL * scale,
              f"f64 {name}: |K2 - plain| {err:.3e} > {F64_K2_RTOL} * "
              f"{scale:.3e}")
        check(torch.equal(yc, y), f"f64 {name}: the checked K2 build "
              "differs from the unchecked")
        return op.variant

    def time_pair(run_k, run_p, reps):
        """ms a call by CUDA events, in turns plain, kernel, kernel, plain
        after 3 warm-up calls of each."""
        for fn in (run_k, run_p):
            for _ in range(3):
                fn()
        times = {"plain": [], "kernel": []}
        for label, fn in (("plain", run_p), ("kernel", run_k),
                          ("kernel", run_k), ("plain", run_p)):
            times[label].append(event_ms(fn, reps))
        return sum(times["kernel"]) / 2, sum(times["plain"]) / 2

    def device_us(fn, cls, reps):
        """Device time of one call's ``cls`` kernels (all kernels: None),
        torch.profiler."""
        ks = [k for k in _trace(fn, reps)
              if cls is None or kernel_class(k[0]) == cls]
        return sum(d for _, _, d in ks) / reps

    def f32_run(op, x, bp, coefs):
        """The same phase on a float32 twin of op (its tables cast)."""
        op32 = stencil.StencilOperator(op._data, torch.float32, dev)
        x32, bp32 = x.float(), bp.float()
        return lambda: K.phase(op32, x32, bp32, coefs)

    def time_entry(name, run_k, run_p, run_32, cls, nbytes, lib, **kv):
        """The timings of one kernels-line entry: ms (kernel) and plain_ms
        by CUDA events, device us of the float64 kernel, of its float32
        twin and of the library call (``lib``: a callable or None), the
        bound of nbytes over 3.35 TB/s."""
        ms, plain_ms = time_pair(run_k, run_p, 20)
        us64 = [device_us(run_k, cls, 20) for _ in range(2)]
        us32 = [device_us(run_32, cls, 20) for _ in range(2)]
        lib_ms = lib_us = None
        if lib is not None:
            for _ in range(3):
                lib()
            lib_ms = event_ms(lib, 20)
            lib_us = device_us(lib, None, 5)
        t = {"name": name, "ms": ms, "plain_ms": plain_ms,
             "device_us": min(us64), "f32_device_us": min(us32),
             "bound_ms": bound_ms(nbytes), "library_ms": lib_ms}
        say("time", phase=35, case=name, dtype="float64", ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}",
            device_us=[f"{v:.2f}" for v in us64],
            f32_device_us=[f"{v:.2f}" for v in us32],
            least_MB=f"{nbytes / 1e6:.2f}",
            bound_us=f"{1e3 * t['bound_ms']:.2f}",
            library_ms=None if lib_ms is None else f"{lib_ms:.5f}",
            library_device_us=None if lib_us is None else f"{lib_us:.2f}",
            card=repr(card), **kv)
        return t

    timed = {}

    def profile(path, p, **kv):
        """A path's device time by kernel class (torch.profiler), wall ms
        by CUDA events and the device's idle share, a cycle or a step."""
        say("profile", phase=35, path=path, dtype="float64",
            by_class={k: f"{v['device_us']:.2f}us/{v['launches']:g}"
                      for k, v in sorted(p["by_class"].items())},
            busy_us=f"{p['device_busy_us']:.2f}",
            ms=f"{p['wall_ms_cuda_events']:.4f}",
            idle_share=f"{p['device_idle_share']:.2f}", card=repr(card),
            **kv)

    # (a) the bench stand-in, float64: the geometric configuration (its fine
    # level streams in float64, resident in float32), one cycle's counts,
    # K1 in each level's tier; then the pin's solver (point Jacobi: every K1
    # launch a zero-round apply) held to bench:s2:l2 ---------------------
    t0 = time.perf_counter()
    bench = bench_solver(dev, dtype="float64")
    op0, op1 = bench.ops
    lim4, lim8 = K.KERNEL.limits(0, 4), K.KERNEL.limits(0, 8)
    say("setup", phase=35, config="bench_f64", dof=3 * op0.C * op0.U,
        levels=[(op.C, op.U, K.KERNEL.plan(op).tier) for op in bench.ops],
        f32_tiers=[K.phase_plan(op.C, op.U, *lim4).tier
                   for op in bench.ops],
        limits_f32=lim4, limits_f64=lim8,
        seconds=f"{time.perf_counter() - t0:.1f}")
    check(K.KERNEL.plan(op0).tier == "stream"
          and K.phase_plan(op0.C, op0.U, *lim4).tier == "resident",
          "the bench fine level in float64 is not in the streaming tier")
    x0, b0, x1, b1 = (rand((3, op.C, op.U)) for op in (op0, op0, op1, op1))
    coefs0 = bench._phase_coefs(0, bench.cfg.n_smooth)
    bp0 = op0._bp(b0, True)
    k1_parity("bench_fine_cheb6_z", op0, x0, bp0, coefs0, True)
    k1_parity("bench_coarse_cheb8", op1, x1, op1._bp(b1, False),
              bench._phase_coefs(1, bench.cfg.coarse_sweeps), False)
    k1_parity("bench_apply_l0", op0, x0, torch.zeros_like(x0), [], True,
              entry="apply")
    k1_parity("bench_apply_l1", op1, x1, torch.zeros_like(x1), [], True,
              entry="apply")
    xt = to_t(bench.initial_condition())
    bt = bench._rhs_t(xt)
    _, c = main_run("bench_cycle", lambda: bench._vcycle_t(0, xt, bt))
    same_counts("bench_cycle", c, f32["bench_cycle"])
    check(c["k1_tiers"].get("stream", 0) > 0, f"bench f64 cycle {c}")
    profile("bench_vcycle_f64", vcycle_profile(bench, 10))
    timed["stream"] = time_entry(
        "k1_phase_f64_stream", lambda: K.phase(op0, x0, bp0, coefs0),
        lambda: K.phase_reference(op0, x0, bp0, coefs0),
        f32_run(op0, x0, bp0, coefs0), "k1_phase", least_bytes(op0, 8), None, C=op0.C, U=op0.U,
        tier="stream", f32_tier="resident", rounds=len(coefs0) + 1)
    zeros0 = torch.zeros_like(x0)
    A, xv = stencil_bsr_matrix(op0), x0.reshape(3, -1).T.reshape(-1)
    lib_z = (A @ xv).reshape(-1, 3).T.reshape(x0.shape)
    lib_err = float((lib_z - K.phase(op0, x0, zeros0, [])[1]).abs().max())
    check(A.dtype == f64 and lib_err <= 1e-12 * float(lib_z.abs().max()),
          f"f64 apply: the BSR yardstick differs from K1 by {lib_err:.3e}")
    timed["apply"] = time_entry(
        "k1_phase_apply_f64", lambda: K.phase(op0, x0, zeros0, []),
        lambda: K.phase_reference(op0, x0, zeros0, []),
        f32_run(op0, x0, zeros0, []), "k1_phase", least_bytes(op0, 8, planes=2), lambda: A @ xv, C=op0.C,
        U=op0.U, tier="stream", library_max_abs_err=f"{lib_err:.3e}")
    del bench, op0, op1, A, xv, lib_z, x0, b0, x1, b1, bp0, zeros0, xt, bt

    key = "bench:s2:l2"
    pin = pins[key]
    mesh = pins_mod.spec_mesh("bench", 2)
    check(pins_mod.mesh_hash(mesh) == pin["x_hash"], f"{key}: X hash")
    p_sv = semi.SemiSolver(semi.build_problem(
        mesh, pins_mod.spec_config(2, 2, dtype="float64")), dev)
    hist, c = main_run(key, lambda: pins_mod.residual_history(
        p_sv, len(pin["residual_linf"])))
    main_launches["apply"] += c["k1_phase"]
    fails = pins_mod.hold(hist, pin, rel=pins_mod.F64_REL, floor="f64_floor")
    say("pin", phase=35, spec=key, dtype="float64",
        residual_linf=[f"{v:.10e}" for v in hist],
        jax_f64=[f"{v:.10e}" for v in pin["residual_linf"]],
        distance=[f"{abs(g - w):.3e}" for g, w in
                  zip(hist, pin["residual_linf"])],
        allowed=[f"{pins_mod.F64_REL * w + 2 * pin['f64_floor']:.3e}"
                 for w in pin["residual_linf"]], fails=fails)
    check(not fails, f"{key} in float64 against its pin: {fails}")
    check(c["k1_rounds"] == c["k1_phase"],
          f"{key}: a K1 launch that was not a zero-round apply")
    same_counts(key, c, f32[key])
    del p_sv, mesh

    # (b) the annulus CLI (--mode 9 --krylov on the .geo annulus, n_split 3,
    # 393,216 DOF) in float64: its V-cycle history held to its pin, its PCG
    # run against the JAX package's; the production amg CLI and the PCG
    # gate in float64 ---------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        geo_path = f"{tmp}/annulus.geo"
        with open(geo_path, "w") as f:
            f.write(pins_mod.ANNULUS_GEO)
        key = "annulus_geo:s3:cli"
        pin = pins[key]
        ann_args = pins_mod.CLI_ARGS + ["--mesh", geo_path, "--n-split", "3",
                                        "--f64", "--device", "cuda"]
        (a_out, T_a, a_sv), c = main_run("annulus_cli",
                                         lambda: cli.run(ann_args))
        check(T_a.dtype == f64, f"{key}: the CLI's state is {T_a.dtype}")
        unit = unit_counts(a_sv)
        c_ann, its_ann, u_ann = f32["annulus_cli"]
        check(unit == u_ann, f"annulus: a Krylov iteration launches {unit} "
              f"in float64, {u_ann} in float32")
        same_counts("annulus_cli", c, c_ann, a_out["krylov_iterations"],
                    its_ann, unit)
        say("main", phase=35, path="annulus_cli_f64", dof=T_a.numel(),
            krylov_iterations=a_out["krylov_iterations"],
            f32_krylov_iterations=its_ann,
            cpu_krylov_iterations=F64_ANNULUS_CLI["krylov_iterations"],
            residual_history=a_out["residual_history"],
            jax_f64=F64_ANNULUS_CLI["residual_history"],
            L1_error=a_out["L1_error"],
            jax_f64_L1_error=F64_ANNULUS_CLI["L1_error"],
            wall_s=a_out["wall_s"], card=repr(card))
        check(abs(a_out["L1_error"] - F64_ANNULUS_CLI["L1_error"])
              <= F64_KRYLOV_REL * F64_ANNULUS_CLI["L1_error"]
              and all(abs(a - b) <= 1 for a, b in zip(
                  a_out["krylov_iterations"],
                  F64_ANNULUS_CLI["krylov_iterations"])),
              f"annulus CLI in float64: {a_out}")
        hist, c = main_run(key, lambda: pins_mod.residual_history(
            a_sv, len(pin["residual_linf"])))
        fails = pins_mod.hold(hist, pin, rel=pins_mod.F64_REL,
                              floor="f64_floor")
        say("pin", phase=35, spec=key, dtype="float64",
            residual_linf=[f"{v:.10e}" for v in hist],
            jax_f64=[f"{v:.10e}" for v in pin["residual_linf"]],
            distance=[f"{abs(g - w):.3e}" for g, w in
                      zip(hist, pin["residual_linf"])],
            allowed=[f"{pins_mod.F64_REL * w + 2 * pin['f64_floor']:.3e}"
                     for w in pin["residual_linf"]], fails=fails)
        check(not fails, f"{key} in float64 against its pin: {fails}")
        same_counts(key, c, f32[key])
        T0_t = to_t(a_sv.initial_condition())
        a_sv.krylov_iters.clear()
        profile("annulus_step_f64", window_profile(
            lambda: a_sv._step_t(T0_t), 2, window=1),
                krylov_iterations=sorted(set(a_sv.krylov_iters)))
        sa = a_sv.agg.rowops() if a_sv.agg is not None else {}
        variants = {k2_parity(f"annulus_{n}", op) for n, op in sa.items()}
        del a_sv, T_a, T0_t

    amg_args = AMG_ARGS + ["--f64", "--device", "cuda"]
    (m_out, T_m, m_sv), c = main_run("amg_cli", lambda: cli.run(amg_args))
    unit = unit_counts(m_sv)
    c_amg, its_amg, u_amg = f32["amg_cli"]
    check(unit == u_amg, f"amg CLI: a Krylov iteration launches {unit} in "
          f"float64, {u_amg} in float32")
    same_counts("amg_cli", c, c_amg, m_out["krylov_iterations"], its_amg,
                unit)
    say("main", phase=35, path="amg_cli_f64", dof=T_m.numel(),
        krylov_iterations=m_out["krylov_iterations"],
        f32_krylov_iterations=its_amg,
        cpu_krylov_iterations=F64_AMG_CLI["krylov_iterations"],
        residual_history=m_out["residual_history"],
        jax_f64=F64_AMG_CLI["residual_history"], L1_error=m_out["L1_error"],
        jax_f64_L1_error=F64_AMG_CLI["L1_error"], wall_s=m_out["wall_s"],
        card=repr(card))
    check(T_m.dtype == f64 and abs(m_out["L1_error"]
                                   - F64_AMG_CLI["L1_error"])
          <= F64_SA_REL * F64_AMG_CLI["L1_error"]
          and all(abs(a - b) <= 1 for a, b in zip(
              m_out["krylov_iterations"], F64_AMG_CLI["krylov_iterations"])),
          f"amg CLI in float64: {m_out}")
    rowops = m_sv.agg.rowops()
    variants |= {k2_parity(f"amg_{n}", op) for n, op in rowops.items()}
    l0 = rowops["l0_op"]
    xl = rand((3, l0.n_src))
    l0_32 = K2.RowOp(l0.tables()[0].T.cpu().numpy(),
                     l0.tables()[1].permute(3, 0, 1, 2).cpu().numpy(),
                     l0.n_src, torch.float32, dev, l0.variant)
    xl32 = xl.float()
    A, xv = bsr_matrix(l0), xl.T.reshape(-1).contiguous()
    lib_err = float(((A @ xv).reshape(l0.n_out, 3).T - l0(xl)).abs().max())
    check(A.dtype == f64 and lib_err <= 1e-12 * float(l0(xl).abs().max()),
          f"f64 l0_op: the BSR yardstick differs from K2 by {lib_err:.3e}")
    timed["k2"] = time_entry(
        "k2_rowop_f64", lambda: l0(xl),
        lambda: K2.rowop_reference(*l0.tables(), xl), lambda: l0_32(xl32),
        "k2_rowop", rowop_least_bytes(l0, 8), lambda: A @ xv,
        rowop="l0_op", N=l0.n_out, D=l0.D, variant=l0.variant,
        lanes=l0.lanes, library_max_abs_err=f"{lib_err:.3e}")
    del m_sv, T_m, rowops, l0, l0_32, A, xv

    (g_out, _, _), c = main_run("gate", lambda: cli.run(
        GATE_ARGS + ["--f64", "--device", "cuda"]))
    say("main", phase=35, path="gate_f64", launches=c,
        krylov_iterations=g_out["krylov_iterations"],
        cpu_krylov_iterations=F64_GATE["krylov_iterations"],
        L1_error=g_out["L1_error"], cpu_L1_error=F64_GATE["L1_error"],
        card=repr(card))
    check(abs(g_out["L1_error"] - F64_GATE["L1_error"])
          <= F64_KRYLOV_REL * F64_GATE["L1_error"]
          and abs(g_out["krylov_iterations"][0]
                  - F64_GATE["krylov_iterations"][0]) <= 1,
          f"the PCG gate in float64: {g_out}")

    # (c) one W-cycle of the level sweep at 6 levels (C = 1024 down to 4,
    # 294,912 DOF) in float64, every phase held to phase_reference as it
    # runs (models.semi.phase wrapped: the plain version adds no launch) --
    t0 = time.perf_counter()
    sweep = sweep_solver(dev, 6, dtype="float64")
    say("setup", phase=35, config="sweep6_f64",
        levels=[(op.C, op.U, K.KERNEL.plan(op).tier) for op in sweep.ops],
        seconds=f"{time.perf_counter() - t0:.1f}")
    real_phase = semi.phase
    held = []

    def phase_held(op, x_t, bp_t, coefs, want_z=True):
        x, z = real_phase(op, x_t, bp_t, coefs, want_z)
        xr, zr = K.phase_reference(op, x_t, bp_t, coefs, want_z)
        tier = K.KERNEL.plan(op).tier
        for got, ref in ((x, xr), (z, zr)) if want_z else ((x, xr),):
            err = float((got - ref).abs().max())
            held.append((op.C, tier, err, float(ref.abs().max())))
            errs[tier] = max(errs[tier], err)
        return x, z

    xt = to_t(sweep.initial_condition())
    bt = sweep._rhs_t(xt)
    semi.phase = phase_held
    try:
        _, c = main_run("sweep6_cycle", lambda: sweep._vcycle_t(0, xt, bt))
    finally:
        semi.phase = real_phase
    worst = max(e / s for _, _, e, s in held)
    say("cycle", phase=35, config="sweep6_f64", k1_launches=c["k1_phase"],
        k1_rounds=c["k1_rounds"], k1_deep=c["k1_deep"],
        k1_tiers=c["k1_tiers"], phases_held=len(held),
        worst_rel=f"{worst:.3e}", tol=F64_K1_RTOL,
        by_c={C: f"{max(e / s for c2, _, e, s in held if c2 == C):.3e}"
              for C in sorted({h[0] for h in held})})
    same_counts("sweep6_cycle", c, f32["sweep6_cycle"])
    check(worst <= F64_K1_RTOL and {t for _, t, _, _ in held}
          >= {"small", "resident"},
          f"the float64 W-cycle's phases: worst {worst:.3e}, tiers "
          f"{sorted({t for _, t, _, _ in held})}")
    opd = sweep.ops[0]
    xd, bd = rand((3, opd.C, opd.U)), rand((3, opd.C, opd.U))
    coefs_d = sweep._phase_coefs(0, sweep.cfg.n_smooth)
    bpd = opd._bp(bd, True)
    k1_parity("sweep_fine_cheb_z", opd, xd, bpd, coefs_d, True)
    timed["resident"] = time_entry(
        "k1_phase_f64_resident", lambda: K.phase(opd, xd, bpd, coefs_d),
        lambda: K.phase_reference(opd, xd, bpd, coefs_d),
        f32_run(opd, xd, bpd, coefs_d), "k1_phase", least_bytes(opd, 8), None, C=opd.C, U=opd.U,
        tier=K.KERNEL.plan(opd).tier, rounds=len(coefs_d) + 1)
    ops_small = [op for op in sweep.ops if op.C > 1
                 and K.KERNEL.plan(op).tier == "small"]
    check(bool(ops_small), "no level of the sweep in K1's small tier")
    li = list(sweep.ops).index(ops_small[0])
    ops = ops_small[0]
    xs, bs = rand((3, ops.C, ops.U)), rand((3, ops.C, ops.U))
    coefs_s = sweep._phase_coefs(li, sweep.cfg.n_smooth)
    bps = ops._bp(bs, False)
    k1_parity("sweep_small_cheb_z", ops, xs, bps, coefs_s, True)
    timed["small"] = time_entry(
        "k1_phase_f64_small", lambda: K.phase(ops, xs, bps, coefs_s),
        lambda: K.phase_reference(ops, xs, bps, coefs_s),
        f32_run(ops, xs, bps, coefs_s), "k1_phase", least_bytes(ops, 8), None, C=ops.C, U=ops.U,
        tier="small", rounds=len(coefs_s) + 1)
    del sweep, opd, ops, xd, bd, bpd, xs, bs, bps, xt, bt

    # (d) mode 6 at 256 x 256 (131,072 elements, C = 1: K1 streams in
    # float64) through the CLI: BiCGStab's iterations a step beside
    # float32's; not gated (the float32 run's 1e-8 stop lies below its
    # floor) ------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path6 = f"{tmp}/painted_{MODE6_N}.msh"
        gmsh.write_msh(path6, painted_mesh(MODE6_N))
        (m6_out, T6, m6_sv), c = main_run("mode6", lambda: cli.run(
            MODE6_ARGS + ["--mesh", path6, "--f64", "--device", "cuda"]))
    op6 = m6_sv.ops[0]
    unit = unit_counts(m6_sv)
    c6, its6, u6, drop6 = f32["mode6"]
    check(unit == u6, f"mode 6: a BiCGStab half-iteration launches {unit} in "
          f"float64, {u6} in float32")
    its = list(m6_sv.krylov_iters)
    drop = krylov_drop(m6_sv)
    say("main", phase=35, path="mode6_f64", elements=m6_out["elements"],
        tier=K.KERNEL.plan(op6).tier, krylov_iterations=its,
        f32_krylov_iterations=its6, first_step_drop=f"{drop[1]:.3e}",
        f32_first_step_drop=f"{drop6[1]:.3e}",
        krylov_tol=m6_sv.cfg.krylov_tol, T_max=float(T6.abs().max()),
        wall_s=m6_out["wall_s"], card=repr(card))
    same_counts("mode6", c, c6, its, its6, unit, per_iteration=2)
    T6_t = to_t(m6_sv.initial_condition())
    m6_sv.krylov_iters.clear()
    profile("mode6_step_f64", window_profile(lambda: m6_sv._step_t(T6_t), 1,
                                             window=1),
            krylov_iterations=sorted(set(m6_sv.krylov_iters)))
    check(T6.dtype == f64 and bool(torch.isfinite(T6).all())
          and float(T6.abs().max()) < 1.5 and (op6.C, op6.U) == (1, 131072)
          and K.KERNEL.plan(op6).tier == "stream",
          "mode 6 in float64: the state is not finite and bounded")
    x6, b6 = rand((3, 1, op6.U)), rand((3, 1, op6.U))
    k1_parity("mode6_cheb_z", op6, x6, op6._bp(b6, True),
              m6_sv._phase_coefs(0, m6_sv.cfg.n_smooth), True)
    k1_parity("mode6_apply", op6, x6, torch.zeros_like(x6), [], True,
              entry="apply")
    del m6_sv, T6, T6_t, op6, x6, b6

    # (e) mode 10 at 393,216 DOF in float64: K2 on the assembled operator
    # (131,072 x 4), one launch a sweep, as in float32 ---------------------
    (t_out, _, t_sv), c = main_run("mode10", lambda: cli.run(
        MODE10_ARGS + ["--f64", "--device", "cuda"]))
    same_counts("mode10", c, f32["mode10"])
    bsr_op = t_sv.A
    variants.add(k2_parity("mode10_A_bsr", bsr_op))
    say("main", phase=35, path="mode10_f64",
        residual_history=t_out["residual_history"],
        jax_f64=F64_MODE10_CLI["residual_history"],
        L1_error=t_out["L1_error"], jax_f64_L1_error=F64_MODE10_CLI[
            "L1_error"], wall_s=t_out["wall_s"], card=repr(card))
    for got, want in zip(t_out["residual_history"] + [t_out["L1_error"]],
                         F64_MODE10_CLI["residual_history"]
                         + [F64_MODE10_CLI["L1_error"]]):
        check(abs(got - want) <= F64_CLI_REL * abs(want),
              f"mode 10 in float64: {got!r} against JAX's {want!r}")
    xb = rand((3, bsr_op.n_src))
    A, xv = bsr_matrix(bsr_op), xb.T.reshape(-1).contiguous()
    ms, plain_ms = time_pair(lambda: bsr_op(xb), lambda: K2.rowop_reference(
        *bsr_op.tables(), xb), 50)
    for _ in range(3):
        A @ xv
    say("time", phase=35, case="mode10_A_bsr_f64", N=bsr_op.n_out,
        D=bsr_op.D, variant=bsr_op.variant, ms=f"{ms:.5f}",
        plain_ms=f"{plain_ms:.5f}",
        device_us=f"{device_us(lambda: bsr_op(xb), 'k2_rowop', 50):.2f}",
        least_MB=f"{rowop_least_bytes(bsr_op, 8) / 1e6:.2f}",
        bound_us=f"{1e3 * bound_ms(rowop_least_bytes(bsr_op, 8)):.2f}",
        library_ms=f"{event_ms(lambda: A @ xv, 50):.5f}",
        library_device_us=f"{device_us(lambda: A @ xv, None, 5):.2f}",
        card=repr(card))
    check(variants == {"thread", "lanes"},
          f"the float64 paths ran K2 variants {variants}")
    del t_sv, bsr_op, A, xv

    # (f) every mode and the CLI's options at small sizes, each command in
    # float32 and in float64 on the card: the state is float64, and K1 /
    # K2 (checked under --debug) launch wherever the float32 run's do, as
    # often where no Krylov count differs; --devices 2 (gloo ranks sharing
    # the card) against the same on CPU ranks, and the distributed
    # solver's K1 / K2 launches on its ranks
    launch_keys = count_keys + ("k1_checked", "k2_checked")
    with tempfile.TemporaryDirectory() as tmp:
        for argv in F64_CLI_MATRIX:
            argv = [a.format(tmp=tmp) for a in argv]
            runs = {}
            for dt, extra in (("float32", []), ("float64", ["--f64"])):
                counts_zero()
                out, T, _ = cli.run(argv + extra + ["--device", "cuda"])
                torch.cuda.synchronize()
                runs[dt] = (out, T, read_counts())
            (o32, T32, c32), (o64, T64, c64) = runs["float32"], runs[
                "float64"]
            same_its = (o64.get("krylov_iterations")
                        == o32.get("krylov_iterations"))
            say("cli", phase=35, argv=" ".join(argv), dtype=str(T64.dtype),
                f64={k: c64[k] for k in launch_keys},
                f32={k: c32[k] for k in launch_keys},
                krylov_f64=o64.get("krylov_iterations"),
                krylov_f32=o32.get("krylov_iterations"),
                wall_s=o64["wall_s"])
            check(T64.dtype == f64 and bool(torch.isfinite(T64).all()),
                  f"{argv} --f64: the state is {T64.dtype}")
            check(all((c64[k] > 0) == (c32[k] > 0) for k in launch_keys)
                  and (not same_its
                       or all(c64[k] == c32[k] for k in launch_keys)),
                  f"{argv} --f64: launches {c64}, float32 {c32}")
            if "--profile" in argv:
                traced = trace_kernels(f"{argv[argv.index('--profile') + 1]}"
                                       "/trace.json")
                n_traced = {cls: sum(kernel_class(k[0]) == cls
                                     for k in traced)
                            for cls in ("k1_phase", "k2_rowop")}
                say("cli", phase=35, profile_traced=n_traced)
                check(all(n_traced[k] == c64[k] > 0 for k in n_traced),
                      f"--profile --f64: traced {n_traced}, counted {c64}")
    g_out = cli.run(F64_DIST_ARGS + ["--f64", "--device", "cuda"])[0]
    c_out = cli.run(F64_DIST_ARGS + ["--f64", "--device", "cpu"])[0]
    say("cli", phase=35, argv=" ".join(F64_DIST_ARGS + ["--f64"]),
        cuda_L1_error=g_out["L1_error"], cpu_L1_error=c_out["L1_error"])
    check(abs(g_out["L1_error"] - c_out["L1_error"])
          <= F64_CLI_REL * abs(c_out["L1_error"]),
          f"--devices 2 --f64: L1 {g_out['L1_error']} on the card, "
          f"{c_out['L1_error']} on CPU ranks")
    from p_a_multigrids_tpu_torch.parallel import cases, comm
    dist_cases = [dict(F64_DIST_CASE, id=f"{name}_{dt}", cfg=dict(
        F64_DIST_CASE["cfg"], dtype=dt, **kw))
        for name, kw in (("geo", {}), ("amg", dict(amg=True,
                                                   multi_levels=1,
                                                   krylov=True)))
        for dt in ("float32", "float64")]
    res = comm.launch(cases.run_cases, 2, dev, args=(dist_cases,),
                      timeout=600)[0]
    for name in ("geo", "amg"):
        r32, r64 = res[f"{name}_float32"], res[f"{name}_float64"]
        diff = float(np.abs(r64["std"] - r64["serial"]).max())
        scale = float(np.abs(r64["serial"]).max())
        say("dist", phase=35, config=name, ranks=2, dtype="float64",
            k1=r64["k1"], k2=r64["k2"], f32_k1=r32["k1"], f32_k2=r32["k2"],
            krylov_f64=r64["krylov_iters"], krylov_f32=r32["krylov_iters"],
            serial_krylov=r64["serial_krylov_iters"],
            max_abs_diff_serial=f"{diff:.3e}", max_abs=f"{scale:.3e}")
        check(r64["std"].dtype == np.float64 and r64["k1"] > 0
              and (r64["k2"] > 0) == (name == "amg")
              and (r64["krylov_iters"] != r32["krylov_iters"]
                   or (r64["k1"], r64["k2"]) == (r32["k1"], r32["k2"])),
              f"distributed {name} in float64: {r64['k1']} K1, "
              f"{r64['k2']} K2 launches, float32 {r32['k1']}, {r32['k2']}")
        # the geometric steps add in the serial order: the same bits; the
        # amg PCG steps agree to 1e-9 in float64
        check(diff == 0.0 if name == "geo" else diff <= 1e-9 * scale,
              f"distributed {name} in float64: {diff:.3e} from serial")

    say("f64", launches=main_launches, max_abs_err=errs,
        seconds=f"{time.perf_counter() - t_phase:.1f}", card=repr(card))
    entries = []
    for key, src, repl in (
            ("stream", "phase.cu", "pallas_stencil.py:176"),
            ("resident", "phase.cu", "pallas_stencil.py:608"),
            ("small", "phase.cu", "pallas_stencil.py:176"),
            ("apply", "phase.cu", "pallas_stencil.py:176"),
            ("k2", "spmv.cu", "pallas_bsr.py:144")):
        t = timed[key]
        launches = (main_launches["k2_rowop"] if key == "k2"
                    else main_launches["apply"] if key == "apply"
                    else main_launches["k1_tiers"][key])
        check(launches > 0, f"{t['name']}: no launch on the float64 paths")
        entries.append({
            "name": t["name"], "route": "cuda",
            "source": f"p_a_multigrids_tpu_torch/csrc/{src}",
            "replaces": f"p_a_multigrids_tpu/ops/{repl}",
            "launches": launches, "max_abs_err": errs[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "device_us": t["device_us"],
            "f32_device_us": t["f32_device_us"]})
    return entries


# Phase 36 (slice 12): the port's bench, ``python -m
# p_a_multigrids_tpu_torch.bench`` in a process of its own on the card (the
# JAX system's second entry surface, bench.py), held to
# validation/bench_pins.json: the root bench.py's functions on the JAX
# package, CPU, float32 (scripts/torch_record_bench.py).  Each rho within
# BENCH_REL of its pin plus the pin's floor (the distance float32 rounding
# alone puts between the JAX float32 and float64 values), PCG iterations
# within one.  The gate is held to its own bound, L1 < 0.01: the card's
# float32 L1 (~9.8e-4) is not the JAX XLA path's (~1.0e-4).
BENCH_REL = 0.02
BENCH_TIMEOUT_S = 600


def bench_phase(card: str) -> dict:
    """Phase 36: the bench's JSON line, checked; returns it."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "p_a_multigrids_tpu_torch", "validation",
                           "bench_pins.json")) as f:
        pins = json.load(f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "p_a_multigrids_tpu_torch.bench"], cwd=here,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    sys.stderr.write(proc.stderr[-6000:])
    lines = proc.stdout.splitlines()
    say("bench", phase=36, rc=proc.returncode, wall_s=f"{wall:.1f}",
        lines=len(lines), card=repr(card))
    check(len(lines) == 1, f"bench printed {len(lines)} lines on stdout")
    print(lines[0], flush=True)
    out = json.loads(lines[0])
    extra = out["extra"]
    check(proc.returncode == 0 and not extra["errors"],
          f"bench exit {proc.returncode}, errors {extra['errors']}")
    sweep = extra["level_sweep_2split_nsplit5"]
    rows = {"geometric": extra["geometric"], "amg": extra["amg"],
            "amg.v11": extra["amg"]["v11"],
            **{f"sweep.{k}": v for k, v in sweep.items()
               if isinstance(v, dict)}}
    bad = sorted(k for k, v in rows.items() if "error" in v)
    check(not bad, f"bench sections with an error: {bad}")
    launches = extra["launches"]
    say("bench", phase=36, k1_phase=extra["k1_phase"],
        k2_spmv=extra["k2_spmv"], k1_tiers=extra["k1_tiers"],
        launches=json.dumps(launches))
    check(extra["k1_phase"] and extra["k2_spmv"]
          and min(launches.values()) > 0,
          "bench: K1 and K2 did not both run the bench (K1 at C > 64 too)")
    check(extra["ndof"] == 393216, f"bench ndof {extra['ndof']}")

    def hold(name, got, pin):
        allowed = BENCH_REL * abs(pin["rho"]) + pin["floor"]
        dist = abs(got - pin["rho"])
        say("pin", phase=36, name=name, rho=got, pin=f"{pin['rho']:.6f}",
            distance=f"{dist:.2e}", allowed=f"{allowed:.2e}")
        check(dist <= allowed, f"bench {name}: rho {got} not within "
              f"{allowed:.2e} of {pin['rho']:.6f}")

    hold("geometric", extra["geometric"]["rho"], pins["geometric"])
    hold("amg", extra["rho"], pins["amg"])
    for k, pin in pins["level_sweep"].items():
        hold(f"sweep.{k}", sweep[k]["rho"], pin)
    for name, got, pin in (
            ("amg", extra["amg"]["pcg_its_to_1e6"],
             pins["amg"]["pcg_its_to_1e6"]),
            ("amg.v11", extra["amg"]["v11"]["pcg_its_to_1e6"],
             pins["amg"]["v11"]["pcg_its_to_1e6"])):
        say("pin", phase=36, name=f"{name}.pcg_its", got=got, pin=pin)
        check(abs(got - pin) <= 1, f"bench {name}: {got} PCG iterations, "
              f"pin {pin}")
    say("bench", phase=36, l1_err=extra["l1_err"],
        jax_f32_l1=pins["gate"]["l1_err"],
        l1_gate_passed=extra["l1_gate_passed"])
    check(extra["l1_gate_passed"], f"bench gate: L1 {extra['l1_err']}")
    return out


# Phase 37 (slice 13): the distributed bench, ``python -m
# p_a_multigrids_tpu_torch.bench_dist`` in processes of its own on the card:
# --devices 1 (retention: one rank under nccl) and --devices 4 (dist8 and
# overhead: four ranks sharing the card under gloo, which checks the
# machinery, not scaling), held to validation/bench_dist_pins.json (the
# JAX package's DistributedStencilSolver on the CPU,
# scripts/torch_record_bench_dist.py): every ghost report, ghost model,
# work fraction, amg_dist_engaged and halo window W equal to the pins,
# integers exactly and fractions within DIST_PIN_TOL (the JAX rounding to
# four digits).  The distributed state after a window's calls from T0 is
# held to the serial twin's: within DIST_BITS_REL where no sharded SA
# correction runs (the same arithmetic: bit for bit in phase 32), within
# phase 32's 2% band where one does (the SA restriction sums in another
# order).  K1 launched on every rank, K2 on every rank with SA rows.
BENCH_DIST_TIMEOUT_S = 900
BENCH_DIST_WORLDS = (1, 4)
DIST_PIN_TOL = 1e-4
DIST_BITS_REL = 1e-6
DIST_BAND_REL = 0.02


def _hold_levels(name: str, got: list, pin: list):
    """A ghost report or model against its pin: integer keys exactly, the
    fractions within DIST_PIN_TOL."""
    check(len(got) == len(pin), f"{name}: {len(got)} levels, pin "
          f"{len(pin)}")
    for g, w in zip(got, pin):
        for k, v in g.items():
            if k.endswith("_frac"):
                check(abs(v - w[k]) <= DIST_PIN_TOL,
                      f"{name} level {g['level']}: {k} {v} against {w[k]}")
            else:
                check(v == w[k], f"{name} level {g['level']}: {k} {v} "
                      f"against {w[k]}")


def _hold_run(name: str, r: dict, unit: str, card: str):
    """One configuration's launches and its state against the twin's."""
    k1, k2 = r["launches"]["k1_phase"], r["launches"]["k2_rowop"]
    tol = DIST_BAND_REL if r.get("amg_dist_engaged") else DIST_BITS_REL
    say("bench_dist", phase=37, config=name, k1=k1, k2=k2,
        sa_rows=r["sa_rows"], dist_vs_serial_rel=r["dist_vs_serial_rel"],
        allowed=tol, setup_s=f"{r['setup_s']:.1f}")
    check(min(k1) > 0, f"{name}: a rank launched no K1: {k1}")
    check(all(n > 0 for n, has in zip(k2, r["sa_rows"]) if has),
          f"{name}: a rank with SA rows launched no K2: {k2}")
    check(math.isfinite(r["dist_vs_serial_rel"])
          and r["dist_vs_serial_rel"] <= tol,
          f"{name}: distributed state {r['dist_vs_serial_rel']:.3e} from "
          f"the serial twin's (allowed {tol})")
    ms = {k: v for k, v in r.items() if k.endswith(f"ms_per_{unit}")}
    say("time", phase=37, config=name, card=repr(card),
        **{k: f"{v:.4f}" for k, v in ms.items()},
        staging_share=f"{r['staging_share']:.3f}",
        wait_share=f"{r['wait_share']:.3f}")


def bench_dist_phase(card: str) -> dict:
    """Phase 37: the distributed bench's JSON lines, checked; returns them
    by world size."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "p_a_multigrids_tpu_torch", "validation",
                           "bench_dist_pins.json")) as f:
        pins = json.load(f)
    lines = {}
    for n in BENCH_DIST_WORLDS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "p_a_multigrids_tpu_torch.bench_dist",
             "--devices", str(n)], cwd=here, capture_output=True, text=True,
            timeout=BENCH_DIST_TIMEOUT_S)
        wall = time.perf_counter() - t0
        sys.stderr.write(proc.stderr[-6000:])
        out_lines = proc.stdout.splitlines()
        say("bench_dist", phase=37, devices=n, rc=proc.returncode,
            wall_s=f"{wall:.1f}", lines=len(out_lines), card=repr(card))
        check(len(out_lines) == 1,
              f"bench_dist printed {len(out_lines)} lines on stdout")
        print(out_lines[0], flush=True)
        out = lines[n] = json.loads(out_lines[0])
        check(proc.returncode == 0 and not out["errors"],
              f"bench_dist --devices {n}: exit {proc.returncode}, errors "
              f"{out['errors']}")
        check(out["backend"] == ("nccl" if n == 1 else "gloo")
              and out["ranks_per_card"] == n,
              f"--devices {n}: {out['backend']}, {out['ranks_per_card']} "
              "ranks a card")
    hold_bench_dist(lines, pins, card)
    return lines


def hold_bench_dist(lines: dict, pins: dict, card: str):
    """Phase 37's holds on the lines of --devices 1 and
    BENCH_DIST_WORLDS[-1]."""
    for name, r in lines[1]["retention"]["configs"].items():
        pin = pins["retention"][name]
        _hold_levels(f"retention {name} ghost_model_at_D8",
                     r["ghost_model_at_D8"], pin["ghost_model_at_D8"])
        check(r["d1_ghost_zones_empty"] and r["k1_phase_dist"]
              and r["amg_tables_built"] == (name == "production_amg"),
              f"retention {name}: {r}")
        _hold_run(f"retention.{name}", r, "cycle", card)
    n = BENCH_DIST_WORLDS[-1]
    configs = lines[n]["dist8"]["configs"]
    check(set(configs) == set(pins["dist8"][f"D{n}"]),
          f"dist8 configs {sorted(configs)}")
    for name, r in configs.items():
        pin = pins["dist8"][f"D{n}"][name]
        _hold_levels(f"dist8 {name} ghost_report", r["ghost_report"],
                     pin["ghost_report"])
        check(abs(r["per_chip_work_fraction"] - pin["per_chip_work_fraction"])
              <= DIST_PIN_TOL and r["amg_dist_engaged"]
              == pin["amg_dist_engaged"] and r["mesh_shape"]
              == pin["mesh_shape"], f"dist8 {name}: {r} against {pin}")
        _hold_run(f"dist8.{name}", r, "cycle", card)
    ov, pin = lines[n]["overhead"], pins["overhead"][f"D{n}"]
    _hold_levels("overhead ghost_report", ov["ghost_report"],
                 pin["ghost_report"])
    check(ov["halo_window_W"] == pin["halo_window_W"]
          and ov["n_macro"] == pin["U"], f"overhead: W {ov['halo_window_W']}"
          f", pin {pin['halo_window_W']}; {ov['n_macro']} macros")
    _hold_run("overhead", ov, "step", card)


# Phase 38 (slice 14): the knob sweep, ``python -m
# p_a_multigrids_tpu_torch.tune_amg`` in a process of its own on the card
# (the JAX system's scripts/tune_amg.py), held to
# validation/tune_amg_pins.json: the script's own rho_linear and pcg_ms on
# the JAX package, CPU, float32 (scripts/torch_record_tune_amg.py).  Each
# rho within BENCH_REL of its pin plus the pin's floor, PCG iterations
# within one, K1 and K2 launched in every case.  Before it, the kernels at
# the shapes its cases give them that no earlier phase met: every K2 rowop
# of the one-sweep hierarchies at agg_target 8 and 4, and the fine phase
# of each Chebyshev degree (16, 12, 10), in this process.
TUNE_TIMEOUT_S = 600
TUNE_PARITY = ("deg16-sw1-t8", "deg12-sw1", "deg10-sw1")


def tune_amg_phase(card: str, parity) -> dict:
    """Phase 38: the knob sweep's cases' kernels held to their plain
    versions (``parity(path, solver)``), then its JSON line, checked;
    returns it."""
    import torch

    from p_a_multigrids_tpu_torch import bench, tune_amg
    from p_a_multigrids_tpu_torch.mesh import structured, topology

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "p_a_multigrids_tpu_torch", "validation",
                           "tune_amg_pins.json")) as f:
        pins = json.load(f)["cases"]
    mesh = topology.rcm_reorder(structured.tri_mesh(*bench.BENCH_MESH))
    knobs = dict(tune_amg.CASES)
    for name in TUNE_PARITY:
        t0 = time.perf_counter()
        sv = tune_amg.solver(mesh, knobs[name], torch.device("cuda", 0))
        say("setup", phase=38, config=name,
            sa_levels=[lv.n for lv in sv.agg.levels],
            seconds=f"{time.perf_counter() - t0:.1f}")
        parity(f"tune_{name}", sv)
        del sv
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "p_a_multigrids_tpu_torch.tune_amg"],
        cwd=here, capture_output=True, text=True, timeout=TUNE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    sys.stderr.write(proc.stderr[-6000:])
    lines = proc.stdout.splitlines()
    say("tune_amg", phase=38, rc=proc.returncode, wall_s=f"{wall:.1f}",
        lines=len(lines), card=repr(card))
    check(len(lines) == 1, f"tune_amg printed {len(lines)} lines on stdout")
    print(lines[0], flush=True)
    out = json.loads(lines[0])
    extra = out["extra"]
    check(proc.returncode == 0 and not extra["errors"],
          f"tune_amg exit {proc.returncode}, errors {extra['errors']}")
    check([r["name"] for r in out["cases"]] == [n for n, _ in tune_amg.CASES]
          and extra["ndof"] == 393216,
          f"tune_amg rows {[r['name'] for r in out['cases']]}, ndof "
          f"{extra['ndof']}")
    for row in out["cases"]:
        name, pin = row["name"], pins[row["name"]]
        launches = row["launches"]
        allowed = BENCH_REL * abs(pin["rho"]) + pin["floor"]
        dist = abs(row["rho"] - pin["rho"])
        say("pin", phase=38, case=name, rho=row["rho"],
            pin=f"{pin['rho']:.6f}", distance=f"{dist:.2e}",
            allowed=f"{allowed:.2e}", pcg_its=row["pcg_its_to_1e6"],
            pin_its=pin["pcg_its_to_1e6"], launches=json.dumps(launches))
        check(launches["k1_phase"] > 0 and launches["k2_rowop"] > 0,
              f"tune_amg {name}: launches {launches}")
        check(dist <= allowed, f"tune_amg {name}: rho {row['rho']} not "
              f"within {allowed:.2e} of {pin['rho']:.6f}")
        check(abs(row["pcg_its_to_1e6"] - pin["pcg_its_to_1e6"]) <= 1,
              f"tune_amg {name}: {row['pcg_its_to_1e6']} PCG iterations, "
              f"pin {pin['pcg_its_to_1e6']}")
        say("time", phase=38, case=name,
            ms_per_cycle=f"{row['ms_per_cycle']:.4f}",
            ms_to_1e6=f"{row['ms_to_1e6']:.3f}",
            pcg_ms_to_1e6=f"{row['pcg_ms_to_1e6']:.3f}",
            setup_s=f"{row['setup_s']:.2f}", card=repr(card))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA device")
    import numpy as np

    from p_a_multigrids_tpu_torch import __main__ as cli
    from p_a_multigrids_tpu_torch.ops import krylov
    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops import spmv as K2
    from p_a_multigrids_tpu_torch.ops.fused import to_t
    from p_a_multigrids_tpu_torch.mesh import gmsh, splitting, structured
    from p_a_multigrids_tpu_torch.mesh.topology import from_msh as gmsh_mesh
    from p_a_multigrids_tpu_torch.ops import galerkin
    from p_a_multigrids_tpu_torch.config import RectConfig
    from p_a_multigrids_tpu_torch.models import (semi_assembled, transport,
                                                 transport_rect)
    from p_a_multigrids_tpu_torch.ops import stencil
    from p_a_multigrids_tpu_torch.utils.profiling import (
        BICGSTAB_ARGS, GS_ARGS, MODE1_ARGS, MODE6_ARGS, MODE6_N, MODE7_ARGS,
        MODE8_ARGS, MODE10_ARGS, NSPLIT7_ARGS, REFERENCE9_ARGS,
        RICHARDSON_ARGS, SWEEP_MESH, THETA_ARGS, amg_solver, bench_solver,
        cli_solver, deep_amg_solver, bound_ms, bsr_matrix, event_ms,
        least_bytes, painted_mesh, rect_step, rowop_least_bytes,
        stencil_bsr_matrix, sweep_solver, transport_solver, _trace,
        kernel_class)
    from p_a_multigrids_tpu_torch.validation import analytical, gates, probe
    from p_a_multigrids_tpu_torch.validation import history as pins_mod
    from p_a_multigrids_tpu_torch.io import vtu as vtu_mod
    from p_a_multigrids_tpu_torch.mesh import geo as geo_mesh
    from p_a_multigrids_tpu_torch.models import semi
    from p_a_multigrids_tpu_torch.utils import cuda_build
    from p_a_multigrids_tpu_torch.utils.expressions import Expression

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. environment -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=repr(kind),
        count=torch.cuda.device_count())
    print(card, flush=True)

    # 2. build: one nvcc per kernel library (K1 and K2, each unchecked and
    # checked) and one c++ per host mesh loader, all started together ------
    kernels = {"k1_phase": K.KERNEL, "k2_rowop": K2.KERNEL,
               "k1_phase_checked": K.CHECKED, "k2_rowop_checked": K2.CHECKED}
    loaders = ("mesh_accel", "gmsh_reader")
    with ThreadPoolExecutor(len(kernels) + len(loaders)) as pool:
        futs = [pool.submit(k.function) for k in kernels.values()]
        host = [pool.submit(cuda_build.load_host, n) for n in loaders]
        for fut in futs:
            fut.result()
        for name, fut in zip(loaders, host):
            info = fut.result()[1]
            say("build", library=name, seconds=f"{info['seconds']:.2f}",
                cached=info["cached"], path=info["path"])
    for name, k in kernels.items():
        info = k.build_info
        say("build", kernel=name, seconds=f"{info['seconds']:.2f}",
            cached=info["cached"], path=info["path"])
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name} ptxas:", line.strip(), flush=True)

    # 3. K1 parity: the bench-geometric and production amg configurations
    # on the stand-in mesh, and the K1 levels of each CLI main path of phase
    # 4, built as the CLI builds them ---------------------------------------
    t0 = time.time()
    solver = bench_solver(dev)
    cfg = solver.cfg
    op0, op1 = solver.ops
    say("setup", config="bench", macros=op0.U,
        dof=3 * op0.C * op0.U, levels=[(op.C, op.U) for op in solver.ops],
        seconds=f"{time.time() - t0:.1f}")
    t0 = time.time()
    amg = amg_solver(dev)
    say("setup", config="amg", dof=3 * amg.ops[0].C * amg.ops[0].U,
        sa_levels=[lv.n for lv in amg.agg.levels],
        seconds=f"{time.time() - t0:.1f}")
    check(len(amg.agg.levels) >= 3, "production SA hierarchy too shallow")
    # the geometric path's C = 1 level is its dense solve; the others'
    # coarsest levels are SA-corrected and relax through K1
    paths = {"cli": (CLI_ARGS, [64, 16, 4]), "amg_cli": (AMG_ARGS, [16]),
             "defaults": (DEFAULT_ARGS, [16, 4])}
    path_sv = {}
    for path, (argv, want_c) in paths.items():
        t0 = time.time()
        sv = path_sv[path] = cli_solver(dev, argv)
        ops = [op for op in sv.ops if op.C > 1]
        say("setup", config=path, dof=3 * sv.ops[0].C * sv.ops[0].U,
            levels=[(op.C, op.U, op.nb) for op in ops],
            sa_levels=None if sv.agg is None else
            [lv.n for lv in sv.agg.levels],
            seconds=f"{time.time() - t0:.1f}")
        check([op.C for op in ops] == want_c,
              f"{path} K1 levels {[op.C for op in ops]}, expected {want_c}")
        check((sv.agg is None) == (path == "cli"),
              f"{path}: SA hierarchy {'missing' if sv.agg is None else 'set'}")
    rng = np.random.default_rng(0)

    def rand(op):
        return torch.as_tensor(
            rng.normal(size=(3, op.C, op.U)).astype(np.float32), device=dev)

    def solver_cases(path, sv, phases=True):
        """A phase with sv's smoothing coefficients and z (when phases), and
        the zero-round apply, on each K1 level of sv."""
        out = []
        for li, op in enumerate(o for o in sv.ops if o.C > 1):
            x, b = rand(op), rand(op)
            coefs = sv._phase_coefs(li, sv.cfg.n_smooth)
            if phases:
                out.append((f"{path}_l{li}_cheb{len(coefs)}_z", op, x,
                            op._bp(b, li == 0), coefs, True, 1e-4))
            out.append((f"{path}_apply_l{li}", op, x, torch.zeros_like(x),
                        [], True, 1e-5))
        return out

    def k1_parity(name, op, x, bp, coefs, want_z, rtol, tier=None):
        """K1 against phase_reference on one phase, in ``tier`` when given
        (one launch, its rounds, at C > DEEP_C a deep launch too, and rtol
        relative to max|plain|); returns the largest absolute
        difference."""
        n0, d0 = K.KERNEL.launches, K.KERNEL.launches_deep
        r0, t0 = K.KERNEL.rounds, dict(K.KERNEL.by_tier)
        xk, zk = K.phase_on_tier(op, x, bp, coefs, want_z, tier)
        torch.cuda.synchronize()
        launched = K.KERNEL.launches - n0
        rounds = len(coefs) + int(want_z)
        used = K.KERNEL.plan(op, tier).tier
        check(launched == 1 and K.KERNEL.rounds - r0 == rounds
              and K.KERNEL.by_tier[used] - t0[used] == 1,
              f"{name}: {launched} launches, {K.KERNEL.rounds - r0} rounds "
              f"for {len(coefs)} rounds + z={want_z}")
        check(K.KERNEL.launches_deep - d0 == int(op.C > K.DEEP_C),
              f"{name}: {K.KERNEL.launches_deep - d0} deep launches at "
              f"C = {op.C}")
        xr, zr = K.phase_reference(op, x, bp, coefs, want_z)
        worst = 0.0
        pairs = [("x", xk, xr)] + ([("z", zk, zr)] if want_z else [])
        for which, got, ref in pairs:
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            worst = max(worst, err)
            say("parity", case=name, out=which, C=op.C, U=op.U, tier=used,
                rounds=rounds, max_abs_err=f"{err:.3e}",
                max_ref=f"{scale:.3e}", rel=f"{err / scale:.3e}",
                tol=rtol)
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
            check(err <= rtol * scale, f"{name} {which}: |K1 - plain| "
                  f"{err:.3e} > {rtol} * {scale:.3e}")
        return worst

    x0, b0 = rand(op0), rand(op0)
    x1, b1 = rand(op1), rand(op1)
    cases = [
        ("fine_cheb6_z", op0, x0, op0._bp(b0, True),
         solver._phase_coefs(0, cfg.n_smooth), True, 1e-4),
        ("coarse_cheb8", op1, x1, op1._bp(b1, False),
         solver._phase_coefs(1, cfg.coarse_sweeps), False, 1e-4),
        ("apply_l0", op0, x0, torch.zeros_like(x0), [], True, 1e-5),
        ("apply_l1", op1, x1, torch.zeros_like(x1), [], True, 1e-5),
        ("fine_cheb6_z_stream", op0, x0, op0._bp(b0, True),
         solver._phase_coefs(0, cfg.n_smooth), True, 1e-4, "stream"),
        ("apply_l0_stream", op0, x0, torch.zeros_like(x0), [], True, 1e-5,
         "stream"),
    ]
    for path, sv in [("amg", amg)] + list(path_sv.items()):
        cases += solver_cases(path, sv)
    max_abs_err = max(k1_parity(*case) for case in cases)

    # 3b. K2 parity: every block-row operator of each SA hierarchy that a
    # main path runs (here the stand-in's production hierarchy, the
    # production CLI's and the CLI defaults'; the deep split's in steps 10
    # and 13) ----------------------------------------------------------------
    def k2_parity(path, rowops):
        """K2 against rowop_reference on every rowop of ``rowops`` (name ->
        RowOp), one launch per apply; returns the largest absolute
        difference."""
        say("rowops", config=path, shapes={
            k: (op.n_out, op.D, op.n_src) for k, op in rowops.items()})
        worst = 0.0
        for name, op in rowops.items():
            x = torch.as_tensor(
                rng.normal(size=(3, op.n_src)).astype(np.float32), device=dev)
            n0 = K2.KERNEL.launches
            got = op(x)
            torch.cuda.synchronize()
            check(K2.KERNEL.launches - n0 == 1,
                  f"{path} {name}: {K2.KERNEL.launches - n0} K2 launches for "
                  "one apply")
            cols_t, vals_t = op.tables()
            ref = K2.rowop_reference(cols_t, vals_t, x)
            # two summation orders of 3*D f32 products each lie within
            # 3*D*2^-24 of the exact sum, relative to the sum of |products|
            absum = float(K2.rowop_reference(cols_t, vals_t.abs(),
                                             x.abs()).max())
            tol = 2 * 3 * op.D * 2.0 ** -24 * absum
            err = float((got - ref).abs().max())
            worst = max(worst, err)
            variants.add(op.variant)
            say("parity", kernel="k2", config=path, case=name, N=op.n_out,
                D=op.D, S=op.n_src, variant=op.variant, lanes=op.lanes,
                max_abs_err=f"{err:.3e}",
                max_ref=f"{float(ref.abs().max()):.3e}", tol=f"{tol:.3e}")
            check(bool(torch.isfinite(got).all()),
                  f"{path} {name}: non-finite")
            check(err <= tol,
                  f"{path} {name}: |K2 - plain| {err:.3e} > {tol:.3e}")
            if op.variant == "lanes":
                # the lane groups add slot sums in the thread variant's
                # order: the same bits
                twin = K2.RowOp(cols_t.T.cpu().numpy(),
                                vals_t.permute(3, 0, 1, 2).cpu().numpy(),
                                op.n_src, torch.float32, dev, "thread")
                check(torch.equal(got, twin(x)),
                      f"{path} {name}: the lanes and thread variants differ")
        return worst

    variants = set()
    rowops = amg.agg.rowops()
    k2_err = max(k2_parity(path, h.rowops()) for path, h in (
        ("amg", amg.agg), ("amg_cli", path_sv["amg_cli"].agg),
        ("defaults", path_sv["defaults"].agg)))
    # the float32 runs' counts that phase 35 holds the float64 runs to
    f32_ref = {}
    amg_unit = unit_counts(path_sv["amg_cli"])
    del path_sv

    # 4. main paths through the CLI entry; each path's counts are set to 0
    # just before it and read just after it ----------------------------------
    check(variants == {"thread", "lanes"},
          f"the SA hierarchies ran K2 variants {variants}")

    def counts_zero():
        K.KERNEL.reset()
        K.CHECKED.reset()
        K2.KERNEL.launches = K2.CHECKED.launches = 0

    def read_counts():
        return {"k1_phase": K.KERNEL.launches, "k1_rounds": K.KERNEL.rounds,
                "k1_deep": K.KERNEL.launches_deep,
                "k1_tiers": {k: v for k, v in K.KERNEL.by_tier.items() if v},
                "k2_rowop": K2.KERNEL.launches,
                "k1_checked": K.CHECKED.launches,
                "k1_checked_rounds": K.CHECKED.rounds,
                "k1_checked_deep": K.CHECKED.launches_deep,
                "k2_checked": K2.CHECKED.launches}

    def drive(args):
        counts_zero()
        out = cli.main(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        return out, read_counts()

    def drive_state(args):
        """drive, also returning the final state and the solver."""
        counts_zero()
        out, T, sv = cli.run(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        return out, read_counts(), T, sv

    def hold_to(name, got, ref, ref_name, rel, key):
        """got[key] (a number or a list) within rel of ref[key]."""
        g, w = got[key], ref[key]
        g, w = (g, w) if isinstance(g, list) else ([g], [w])
        check(len(g) == len(w), f"{name} {key}: {len(g)} values, "
              f"{ref_name} {len(w)}")
        for a, b in zip(g, w):
            check(math.isfinite(a) and abs(a - b) <= rel * abs(b),
                  f"{name} {key}: {a:.7g} not within {rel} of the "
                  f"{ref_name} {b:.7g}")

    out, counts = drive(CLI_ARGS)
    main_launches = counts["k1_phase"]
    hist = out["residual_history"]
    say("main", path="geometric", launches=counts, residual_history=hist,
        jax_cpu=CLI_HISTORY, L1_error=out["L1_error"],
        wall_s=out["wall_s"])
    check(main_launches > 0, "the main path launched K1 no time")
    check(all(np.isfinite(v) for v in hist + [out["L1_error"],
                                              out["residual"]]),
          "non-finite CLI output")
    check(len(hist) == len(CLI_HISTORY), "residual history length")
    for got, want in zip(hist, CLI_HISTORY):
        check(abs(got - want) <= 0.01 * want,
              f"CLI residual {got:.6g} not within 1% of {want}")

    amg_out, amg_counts = drive(AMG_ARGS)
    f32_ref["amg_cli"] = (amg_counts, amg_out["krylov_iterations"], amg_unit)
    say("main", path="amg_pcg", launches=amg_counts,
        residual_history=amg_out["residual_history"],
        jax_cpu=AMG_CLI["residual_history"],
        krylov_iterations=amg_out["krylov_iterations"],
        jax_krylov_iterations=AMG_CLI["krylov_iterations"],
        L1_error=amg_out["L1_error"], jax_L1_error=AMG_CLI["L1_error"],
        wall_s=amg_out["wall_s"])
    check(amg_counts["k1_phase"] > 0 and amg_counts["k2_rowop"] > 0,
          f"the amg path did not launch both kernels: {amg_counts}")
    check(all(np.isfinite(v) for v in amg_out["residual_history"]
              + [amg_out["L1_error"], amg_out["residual"]]),
          "non-finite amg CLI output")
    # f32 moves L1 by about 0.5% from the f64 solution (0.136846) in each
    # package, the opposite way in each (JAX CPU 0.136284; the port on CPU
    # 0.137560, its phase-based A x = -D z apply), so 2%.  PCG stops at a
    # 1e-6 2-norm drop, where the max-norm residual is within 4-5x of its
    # f32 evaluation floor; JAX alone moves it by 7% between two
    # evaluations of one state, so 25%.  The f32 iteration count at that
    # stop moves by one (JAX: 5 or 6 in step 1 by evaluation order), +-1.
    check(abs(amg_out["L1_error"] - AMG_CLI["L1_error"])
          <= 0.02 * AMG_CLI["L1_error"], "amg CLI L1_error not within 2%")
    for got, want in zip(amg_out["residual_history"],
                         AMG_CLI["residual_history"]):
        check(abs(got - want) <= 0.25 * want,
              f"amg CLI residual {got:.4e} not within 25% of {want:.4e}")
    check(len(amg_out["krylov_iterations"]) == 2 and all(
        abs(a - b) <= 1 for a, b in zip(amg_out["krylov_iterations"],
                                        AMG_CLI["krylov_iterations"])),
          f"amg CLI iterations {amg_out['krylov_iterations']}")

    dflt, dflt_counts = drive(DEFAULT_ARGS)
    say("main", path="defaults_coarse_agg", launches=dflt_counts,
        residual_history=dflt["residual_history"], jax_cpu=DEFAULT_HISTORY,
        wall_s=dflt["wall_s"])
    check(dflt_counts["k1_phase"] > 0 and dflt_counts["k2_rowop"] > 0,
          f"the defaults path did not launch both kernels: {dflt_counts}")
    for got, want in zip(dflt["residual_history"], DEFAULT_HISTORY):
        check(abs(got - want) <= 0.01 * want,
              f"defaults residual {got:.6g} not within 1% of {want}")

    # 5. bench-geometric configuration at 393,216 DOF ------------------------
    def cycle_ms(sv):
        """ms per cycle of sv from T0 by CUDA events: 20 cycles after 3."""
        b_t = sv._rhs_t(to_t(sv.initial_condition()))
        state = {"x": to_t(sv.initial_condition())}

        def cycle():
            state["x"] = sv._vcycle_t(0, state["x"], b_t)

        for _ in range(3):
            cycle()
        return event_ms(cycle, 20)

    def cycle_counts(key, sv):
        """K1 launches and rounds in one cycle of sv from T0, against
        CYCLE_K1 (counts set to 0 just before, read just after)."""
        x_t = to_t(sv.initial_condition())
        b_t = sv._rhs_t(x_t)
        counts_zero()
        sv._vcycle_t(0, x_t, b_t)
        torch.cuda.synchronize()
        c = read_counts()
        say("cycle", config=key, k1_launches=c["k1_phase"],
            k1_rounds=c["k1_rounds"], k1_tiers=c["k1_tiers"],
            k2_launches=c["k2_rowop"], want_k1=CYCLE_K1[key])
        check((c["k1_phase"], c["k1_rounds"]) == CYCLE_K1[key],
              f"{key}: K1 {c['k1_phase']} launches, {c['k1_rounds']} rounds "
              f"a cycle, expected {CYCLE_K1[key]}")
        return c

    def pcg_to_1e6(sv):
        """PCG on sv's linear system from T0's right-hand side, x0 = 0, to a
        1e-6 drop, preconditioned by one homogeneous cycle."""
        b_t = sv._rhs_t(to_t(sv.initial_condition()))
        b_lin = b_t - sv.ops[0].apply(torch.zeros_like(b_t), True)
        return lambda: krylov.pcg(
            lambda v: sv._apply_t(0, v, False), b_lin,
            torch.zeros_like(b_lin),
            precond=lambda r: sv._vcycle_t(0, torch.zeros_like(r), r,
                                           hom=True),
            tol=1e-6, maxiter=40)

    f32_ref["bench_cycle"] = cycle_counts("bench", solver)
    bench = history(solver)
    say("bench", residual_history=[f"{v:.4e}" for v in bench])
    say("bench", jax_cpu=BENCH_HISTORY)
    for got, want in zip(bench, BENCH_HISTORY):
        check(np.isfinite(got) and abs(got - want) <= 0.02 * want,
              f"bench residual {got:.4e} not within 2% of {want:.4e}")
    vc_ms = cycle_ms(solver)
    say("bench", ms_per_vcycle=f"{vc_ms:.4f}", card=repr(card))

    # 5b. production amg V-cycle and PCG to 1e-6 at 393,216 DOF -------------
    cycle_counts("amg", amg)
    amg_hist = history(amg)
    say("amg", residual_history=[f"{v:.4e}" for v in amg_hist])
    say("amg", jax_cpu=AMG_HISTORY, floor=AMG_FLOOR)
    for i, (got, want) in enumerate(zip(amg_hist, AMG_HISTORY)):
        check(np.isfinite(got), f"amg cycle {i + 1} non-finite")
        if want > 2 * AMG_FLOOR:        # above the floor: within 2%
            check(abs(got - want) <= 0.02 * want,
                  f"amg cycle {i + 1}: {got:.4e} not within 2% of "
                  f"{want:.4e}")
        else:                           # on the floor: stays there
            check(got <= 2 * AMG_FLOOR,
                  f"amg cycle {i + 1}: {got:.4e} above 2x the f32 floor")
    amg_ms = cycle_ms(amg)
    say("amg", ms_per_vcycle=f"{amg_ms:.4f}", card=repr(card))

    pcg_solve = pcg_to_1e6(amg)
    _, pcg_its, _ = pcg_solve()
    check(abs(pcg_its - AMG_PCG_ITERS) <= 1,
          f"amg PCG took {pcg_its} iterations, JAX CPU {AMG_PCG_ITERS}")
    pcg_ms = event_ms(pcg_solve, 5)
    say("amg", pcg_iterations=pcg_its, jax_cpu_iterations=AMG_PCG_ITERS,
        ms_to_1e6=f"{pcg_ms:.4f}", card=repr(card))

    # 6. manufactured gate with PCG -----------------------------------------
    gate = cli.main(GATE_ARGS + ["--device", "cuda"])
    say("gate", L1_error=gate["L1_error"],
        krylov_iterations=gate["krylov_iterations"],
        residual=gate["residual"])
    check(np.isfinite(gate["L1_error"]) and gate["L1_error"] < 0.01,
          f"gate L1_error {gate['L1_error']} >= 0.01")

    # 7. K1 against the plain version, one fine deg-6 phase ------------------
    def time_pair(run_k, run_p, reps):
        """ms per call of the kernel and of its plain version by CUDA
        events: 3 warm-up calls of each, then reps calls in turns plain,
        kernel, kernel, plain (the kernel is called 3 + 2 reps times)."""
        for fn in (run_k, run_p):
            for _ in range(3):
                fn()
        times = {"plain": [], "kernel": []}
        for label, fn in (("plain", run_p), ("kernel", run_k),
                          ("kernel", run_k), ("plain", run_p)):
            times[label].append(event_ms(fn, reps))
        return sum(times["kernel"]) / 2, sum(times["plain"]) / 2, times

    coefs = solver._phase_coefs(0, cfg.n_smooth)
    bp0 = op0._bp(b0, True)
    n_before, r_before = K.KERNEL.launches, K.KERNEL.rounds
    k_ms, p_ms, times = time_pair(
        lambda: K.phase(op0, x0, bp0, coefs, True),
        lambda: K.phase_reference(op0, x0, bp0, coefs, True), 20)
    check(K.KERNEL.launches - n_before == 43
          and K.KERNEL.rounds - r_before == 43 * (len(coefs) + 1),
          "timed kernel phases did not launch K1 once each")
    k1_bound = bound_ms(least_bytes(op0))
    say("time", phase="fine_cheb6_z", C=op0.C, U=op0.U,
        tier=K.KERNEL.plan(op0).tier, k1_ms=f"{k_ms:.4f}",
        plain_ms=f"{p_ms:.4f}", bound_ms=f"{k1_bound:.4f}",
        k1_runs=[f"{v:.4f}" for v in times["kernel"]],
        plain_runs=[f"{v:.4f}" for v in times["plain"]], card=repr(card))

    # 8. K2 against the plain version, its bound and the library call that
    # computes the same product (a sparse BSR matrix built once from the
    # RowOp, times the vector in the layout it wants): the level-0 operator,
    # the fine tentative restriction and the wide SA restrictions ---------
    k2_ms = {}
    for name in ("l0_op", "fine_tent_r", "l2_r", "l3_r"):
        op = rowops[name]
        x = torch.as_tensor(rng.normal(size=(3, op.n_src)).astype(np.float32),
                            device=dev)
        n_before = K2.KERNEL.launches
        ms, plain_ms, times = time_pair(
            lambda: op(x),
            lambda: K2.rowop_reference(*op.tables(), x), 50)
        check(K2.KERNEL.launches - n_before == 103,
              f"timed {name} applies did not launch K2")
        A, xv = bsr_matrix(op), x.T.reshape(-1).contiguous()
        lib_y = (A @ xv).reshape(op.n_out, 3).T
        lib_err = float((lib_y - op(x)).abs().max())
        check(lib_err <= 1e-5 * float(lib_y.abs().max()),
              f"{name}: the BSR yardstick differs from K2 by {lib_err:.3e}")
        for _ in range(3):
            A @ xv
        lib_ms = event_ms(lambda: A @ xv, 50)
        backend = sorted({k for k, _, _ in _trace(lambda: A @ xv, 5)})
        k2_ms[name] = (ms, plain_ms, bound_ms(rowop_least_bytes(op)), lib_ms)
        say("time", rowop=name, N=op.n_out, D=op.D, S=op.n_src,
            variant=op.variant, lanes=op.lanes, k2_ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{k2_ms[name][2]:.5f}",
            library_ms=f"{lib_ms:.5f}", library_kernels=backend,
            k2_runs=[f"{v:.5f}" for v in times["kernel"]],
            plain_runs=[f"{v:.5f}" for v in times["plain"]], card=repr(card))

    # 9. the production CLI path against the port's plain PyTorch version:
    # the same command on the host CPU in f32 (no kernel launches) ---------
    cpu_out = cli.main(AMG_ARGS + ["--device", "cpu"])
    say("main", path="amg_pcg_cpu_plain",
        residual_history=amg_out["residual_history"],
        cpu=cpu_out["residual_history"],
        krylov_iterations=amg_out["krylov_iterations"],
        cpu_krylov_iterations=cpu_out["krylov_iterations"],
        L1_error=amg_out["L1_error"], cpu_L1_error=cpu_out["L1_error"],
        cpu_wall_s=cpu_out["wall_s"])
    # The iteration counts are the witness of the SA correction: PCG
    # reaches about the same solution under any SPD preconditioner, but not
    # in the same number of iterations.  L1 of the two f32 runs agreed to 7e-6
    # relative, so 1e-4.  The residuals are max|b - A x| of states near
    # the f32 evaluation floor (step 2 lies at 1.7e-5) evaluated by K1 and
    # by the plain version in other summation orders; they differed by 1%
    # and 8% (H100 80GB HBM3, 700 W), so 25%, as against JAX above.
    check(amg_out["krylov_iterations"] == cpu_out["krylov_iterations"],
          f"amg CLI iterations {amg_out['krylov_iterations']}, plain CPU "
          f"{cpu_out['krylov_iterations']}")
    check(abs(amg_out["L1_error"] - cpu_out["L1_error"])
          <= 1e-4 * cpu_out["L1_error"],
          f"amg CLI L1 {amg_out['L1_error']} not within 1e-4 of the plain "
          f"CPU {cpu_out['L1_error']}")
    for got, want in zip(amg_out["residual_history"],
                         cpu_out["residual_history"]):
        check(abs(got - want) <= 0.25 * want,
              f"amg CLI residual {got:.6e} not within 25% of the plain CPU "
              f"{want:.6e}")

    # 10. the deep-split path (n_split 5, C = 1024): the level sweep's
    # solvers at levels 1-6, the Galerkin configuration and the production
    # amg row on the stand-in mesh, with each host setup's seconds ---------
    deep = {}
    for key in list(SWEEP_HISTORY) + ["galerkin4", "amg"]:
        t0 = time.time()
        if key == "amg":
            sv = deep_amg_solver(dev)
        elif key == "galerkin4":
            sv = sweep_solver(dev, 4, coarse_operator="galerkin")
        else:
            sv = sweep_solver(dev, key)
        deep[key] = sv
        say("setup", config=f"sweep_{key}", dof=3 * sv.ops[0].C * sv.ops[0].U,
            levels=[(op.C, op.U) for op in sv.ops],
            sa_levels=None if sv.agg is None else
            [lv.n for lv in sv.agg.levels],
            dense_coarse=sv.coarse_inv_t is not None,
            seconds=f"{time.time() - t0:.1f}")
        check(sv.ops[0].C == 1024 and 3 * sv.ops[0].C * sv.ops[0].U
              == 294912, f"sweep_{key}: not the 294,912-DOF stand-in")
    for key in SWEEP_HISTORY:
        check((deep[key].agg is not None) == (key in (2, 3, 4)),
              f"sweep_{key}: SA levels below the coarsest "
              f"{'missing' if deep[key].agg is None else 'set'}")
    # the Galerkin triple products alone, on the 4-level geometric stencils;
    # the timed Galerkin solver must hold exactly these coarse blocks, and
    # they must differ from the geometric ones (surface terms are on)
    geo = [op._data for op in deep[4].ops]
    datas = list(geo)
    t0 = time.time()
    for i in range(1, len(datas)):
        datas[i] = galerkin.galerkin_coarse(
            datas[i - 1], deep[4].p.levels[i]["s"], datas[i])
    say("setup", galerkin_coarse_seconds=f"{time.time() - t0:.2f}",
        levels=len(datas) - 1, fine_C=[4 ** (5 - i) for i in range(3)])
    blocks = ("self_blocks", "face_blocks", "cross_blocks")
    for i in range(1, len(datas)):
        held = deep["galerkin4"].ops[i]._data
        check(all(np.array_equal(getattr(datas[i], k), getattr(held, k))
                  for k in blocks),
              f"galerkin4 level {i}: coarse blocks are not P^T A P")
        check(not all(np.array_equal(getattr(geo[i], k), getattr(held, k))
                      for k in blocks),
              f"galerkin4 level {i}: coarse blocks equal the geometric ones")
    # K2 at the deep split's SA shapes: below the geometric coarsest of
    # sweep levels 2-4, and the amg row's hierarchy of 98,304 elements
    for key in (2, 3, 4, "amg"):
        k2_err = max(k2_err, k2_parity(f"sweep_{key}",
                                       deep[key].agg.rowops()))

    # 11. K1 in the TPU's PhaseOperatorResident regime: every K1 level of
    # the sweep at 1 and 6 levels (C = 1024, 256, 64, 16, 4 at U = 96), a
    # degree-6 phase with z and the zero-round apply -----------------------
    k3_err = 0.0
    for key in (1, 6):
        for case in solver_cases(f"sweep{key}", deep[key]):
            err = k1_parity(*case)
            if case[1].C > K.DEEP_C:
                k3_err = max(k3_err, err)
            else:
                max_abs_err = max(max_abs_err, err)
    # and the streaming tier at C = 1024, forced
    op_d = deep[1].ops[0]
    xd, bd = rand(op_d), rand(op_d)
    k3_err = max(k3_err, k1_parity(
        "sweep1_l0_cheb6_z_stream", op_d, xd, op_d._bp(bd, True),
        deep[1]._phase_coefs(0, deep[1].cfg.n_smooth), True, 1e-4, "stream"))

    # 12. the level sweep on the card: 10 cycles from T0 at levels 1-6, the
    # Galerkin configuration and the amg row; each run's counts are set to
    # 0 just before it and read just after it ------------------------------
    f32_ref["sweep6_cycle"] = cycle_counts(6, deep[6])
    sweep_deep_launches = 0
    wants = dict(SWEEP_HISTORY, galerkin4=GALERKIN4_HISTORY,
                 amg=DEEP_AMG_HISTORY)
    for key, sv in deep.items():
        counts_zero()
        hist = history(sv)
        torch.cuda.synchronize()
        c = read_counts()
        if key in SWEEP_HISTORY:
            sweep_deep_launches += c["k1_deep"]
        ms = cycle_ms(sv)
        say("sweep", config=key, launches=c,
            residual_history=[f"{v:.4e}" for v in hist])
        say("sweep", config=key, jax_cpu=wants[key], ms_per_cycle=f"{ms:.4f}",
            card=repr(card))
        check(c["k1_deep"] > 0, f"sweep_{key} launched K1 at C = 1024 no time")
        check((c["k2_rowop"] > 0) == (sv.agg is not None),
              f"sweep_{key}: {c['k2_rowop']} K2 launches")
        hold_history(f"sweep_{key}", hist, wants[key])

    deep_pcg = pcg_to_1e6(deep["amg"])
    _, deep_its, _ = deep_pcg()
    deep_pcg_ms = event_ms(deep_pcg, 3)
    say("sweep", config="amg", pcg_iterations=deep_its,
        jax_cpu_iterations=DEEP_AMG_PCG_ITERS,
        ms_to_1e6=f"{deep_pcg_ms:.4f}", card=repr(card))
    # the f32 stop at a 1e-6 2-norm drop moves by one iteration between
    # summation orders (section 4)
    check(abs(deep_its - DEEP_AMG_PCG_ITERS) <= 1,
          f"deep amg PCG took {deep_its} iterations, JAX CPU "
          f"{DEEP_AMG_PCG_ITERS}")
    sweep1 = deep[1]
    del deep

    # 13. the CLI with --mesh: a gmsh file of the stand-in at n_split 4 on
    # the card (counts set to 0 just before, read just after), then the same
    # command on the host CPU (the plain PyTorch path, f32) ----------------
    with tempfile.TemporaryDirectory() as tmp:
        mesh = structured.tri_mesh(*SWEEP_MESH)
        mesh.region_id = np.where(np.arange(mesh.num_elements) % 3 == 0, 4,
                                  1).astype(np.int32)
        path = f"{tmp}/stand_in.msh"
        gmsh.write_msh(path, mesh)
        mesh_argv = MESH_ARGS + ["--mesh", path]
        k2_err = max(k2_err, k2_parity(
            "mesh_cli", cli_solver(dev, mesh_argv).agg.rowops()))
        mesh_out, mesh_counts = drive(mesh_argv)
        mesh_cpu = cli.main(mesh_argv + ["--device", "cpu"])
    say("main", path="mesh_cli", launches=mesh_counts,
        residual_history=mesh_out["residual_history"],
        cpu=mesh_cpu["residual_history"], jax_cpu=MESH_CLI["residual_history"],
        L1_error=mesh_out["L1_error"], cpu_L1_error=mesh_cpu["L1_error"],
        jax_L1_error=MESH_CLI["L1_error"], wall_s=mesh_out["wall_s"],
        cpu_wall_s=mesh_cpu["wall_s"])
    check(mesh_out["elements"] == 96 and mesh_out["children"] == 256,
          "mesh CLI: not the stand-in at n_split 4")
    check(mesh_counts["k1_deep"] > 0 and mesh_counts["k2_rowop"] > 0,
          f"the mesh CLI did not launch K1 at C = 256 and K2: {mesh_counts}")
    # port CPU and JAX CPU agreed to 1e-6 relative on this command; f32
    # sums in the kernels' order move a V-cycle history by far less than 1%
    for ref_name, ref in (("plain CPU", mesh_cpu), ("JAX CPU", MESH_CLI)):
        check(abs(mesh_out["L1_error"] - ref["L1_error"])
              <= 1e-4 * ref["L1_error"],
              f"mesh CLI L1 {mesh_out['L1_error']} not within 1e-4 of the "
              f"{ref_name} {ref['L1_error']}")
        for got, want in zip(mesh_out["residual_history"],
                             ref["residual_history"]):
            check(abs(got - want) <= 0.01 * want,
                  f"mesh CLI residual {got:.6g} not within 1% of the "
                  f"{ref_name} {want:.6g}")

    # 14. K1 against the plain version in K3's regime: one fine degree-6
    # phase at C = 1024 (the sweep's level 0) ------------------------------
    coefs = sweep1._phase_coefs(0, sweep1.cfg.n_smooth)
    bpd = op_d._bp(bd, True)
    n_before, r_before = K.KERNEL.launches_deep, K.KERNEL.rounds
    k3_ms, k3_plain_ms, times = time_pair(
        lambda: K.phase(op_d, xd, bpd, coefs, True),
        lambda: K.phase_reference(op_d, xd, bpd, coefs, True), 20)
    check(K.KERNEL.launches_deep - n_before == 43
          and K.KERNEL.rounds - r_before == 43 * (len(coefs) + 1),
          "timed C = 1024 phases did not launch K1 once each")
    k3_bound = bound_ms(least_bytes(op_d))
    say("time", phase="deep_fine_cheb6_z", C=op_d.C, U=op_d.U,
        tier=K.KERNEL.plan(op_d).tier, k1_ms=f"{k3_ms:.4f}",
        plain_ms=f"{k3_plain_ms:.4f}", bound_ms=f"{k3_bound:.4f}",
        k1_runs=[f"{v:.4f}" for v in times["kernel"]],
        plain_runs=[f"{v:.4f}" for v in times["plain"]], card=repr(card))

    # 15. mode 10: the assembled operator (131,072 x 4 blocks) through K2,
    # once a block-Jacobi sweep, at 393,216 DOF ---------------------------
    t0 = time.time()
    m10 = cli_solver(dev, MODE10_ARGS)
    bsr_op = m10.A
    say("setup", config="mode10", dof=3 * bsr_op.n_out,
        rowop=(bsr_op.n_out, bsr_op.D, bsr_op.n_src), variant=bsr_op.variant,
        sweeps_a_step=m10.sweeps(), seconds=f"{time.time() - t0:.1f}")
    check((bsr_op.n_out, bsr_op.D, bsr_op.n_src) == (131072, 4, 131072)
          and m10.sweeps() == MODE10_SWEEPS, "mode 10: not the 131,072 x 4 "
          f"operator with {MODE10_SWEEPS} sweeps a step")
    k2_bsr_err = k2_parity("mode10", {"A_bsr": bsr_op})
    m10_out, m10_counts = drive(MODE10_ARGS)
    f32_ref["mode10"] = m10_counts
    m10_cpu = cli.main(MODE10_ARGS + ["--device", "cpu"])
    ntime = len(m10_out["residual_history"])
    say("main", path="mode10", launches=m10_counts,
        residual_history=m10_out["residual_history"],
        cpu=m10_cpu["residual_history"],
        jax_cpu=MODE10_CLI["residual_history"], L1_error=m10_out["L1_error"],
        cpu_L1_error=m10_cpu["L1_error"], jax_L1_error=MODE10_CLI["L1_error"],
        wall_s=m10_out["wall_s"], cpu_wall_s=m10_cpu["wall_s"])
    # one K2 launch a sweep; K1 runs the zero-round apply of each residual
    # (one a step and the final one)
    check(m10_counts["k2_rowop"] == MODE10_SWEEPS * ntime,
          f"mode 10: {m10_counts['k2_rowop']} K2 launches for "
          f"{MODE10_SWEEPS * ntime} sweeps")
    check(m10_counts["k1_phase"] == ntime + 1,
          f"mode 10: {m10_counts['k1_phase']} K1 launches for "
          f"{ntime + 1} residuals")
    # the port's plain path and JAX (both f32 on a CPU) agreed to 6e-7
    # relative in the history and exactly in L1
    for ref_name, ref in (("plain CPU", m10_cpu), ("JAX CPU", MODE10_CLI)):
        hold_to("mode 10", m10_out, ref, ref_name, 1e-4, "residual_history")
        hold_to("mode 10", m10_out, ref, ref_name, 1e-5, "L1_error")
    x = torch.as_tensor(rng.normal(size=(3, bsr_op.n_src)).astype(
        np.float32), device=dev)
    n_before = K2.KERNEL.launches
    bsr_ms, bsr_plain_ms, times = time_pair(
        lambda: bsr_op(x), lambda: K2.rowop_reference(*bsr_op.tables(), x),
        50)
    check(K2.KERNEL.launches - n_before == 103,
          "timed mode-10 applies did not launch K2 once each")
    A, xv = bsr_matrix(bsr_op), x.T.reshape(-1).contiguous()
    lib_err = float(((A @ xv).reshape(-1, 3).T - bsr_op(x)).abs().max())
    check(lib_err <= 1e-5 * float(bsr_op(x).abs().max()),
          f"mode 10: the BSR yardstick differs from K2 by {lib_err:.3e}")
    for _ in range(3):
        A @ xv
    bsr_lib_ms = event_ms(lambda: A @ xv, 50)
    bsr_bound = bound_ms(rowop_least_bytes(bsr_op))
    say("time", rowop="mode10_A_bsr", N=bsr_op.n_out, D=bsr_op.D,
        variant=bsr_op.variant, k2_ms=f"{bsr_ms:.5f}",
        plain_ms=f"{bsr_plain_ms:.5f}", bound_ms=f"{bsr_bound:.5f}",
        least_MB=f"{rowop_least_bytes(bsr_op) / 1e6:.2f}",
        library_ms=f"{bsr_lib_ms:.5f}",
        k2_runs=[f"{v:.5f}" for v in times["kernel"]],
        plain_runs=[f"{v:.5f}" for v in times["plain"]], card=repr(card))
    T10 = m10.initial_condition()
    m10._step(T10)
    say("time", step="mode10",
        ms_per_step=f"{event_ms(lambda: m10._step(T10), 5):.4f}",
        card=repr(card))
    del m10, bsr_op, A

    # 16. mode 8 at the CLI defaults (38,400 DOF): the dense inverse on the
    # card, held to mode 9's PCG on the same steps; a small command to JAX
    m8_out, m8_counts, T8, m8 = drive_state(MODE8_ARGS)
    m9_out, _, T9, _ = drive_state(MODE8_PCG_ARGS)
    n8 = m8.Ainv.shape[0]
    diff = float((T8 - T9).abs().max())
    T0 = m8.initial_condition()
    step8_ms = event_ms(lambda: semi_assembled.direct_step(m8, T0), 20)
    step8_bound = bound_ms(n8 * n8 * 4)
    say("main", path="mode8", launches=m8_counts, dof=n8,
        inverse_GB=f"{n8 * n8 * 4 / 1e9:.2f}",
        inverse_seconds=f"{m8.inverse_seconds:.3f}",
        ms_per_step=f"{step8_ms:.4f}", step_bound_ms=f"{step8_bound:.4f}",
        L1_error=m8_out["L1_error"], pcg_L1_error=m9_out["L1_error"],
        max_abs_diff_pcg=f"{diff:.3e}",
        pcg_iterations=m9_out["krylov_iterations"], card=repr(card))
    # PCG stops at a 1e-6 drop of the residual, the f32 inverse at its
    # rounding: they agreed to 2.4e-7 (max |T| 0.46) on the CPU at 8 x 8
    check(n8 == 38400 and diff <= 1e-5,
          f"mode 8 differs from mode-9 PCG by {diff:.3e}")
    del m8, T0
    m8s_out = cli.main(MODE8_SMALL_ARGS + ["--device", "cuda"])
    for key in ("L1_error", "residual"):
        hold_to("mode 8 small", m8s_out, MODE8_SMALL_CLI, "JAX CPU", 1e-4,
                key)

    # 17. mode 7 (theta = 0: one block-Jacobi round a step) at 393,216 DOF,
    # dt 5e-8, 10 steps ----------------------------------------------------
    m7_out, m7_counts = drive(MODE7_ARGS)
    m7_cpu = cli.main(MODE7_ARGS + ["--device", "cpu"])
    steps7 = len(m7_out["residual_history"])
    say("main", path="mode7", launches=m7_counts,
        residual_history=m7_out["residual_history"],
        cpu=m7_cpu["residual_history"],
        jax_cpu=MODE7_CLI["residual_history"], L1_error=m7_out["L1_error"],
        cpu_L1_error=m7_cpu["L1_error"], jax_L1_error=MODE7_CLI["L1_error"],
        wall_s=m7_out["wall_s"])
    # a step's phase and each residual's zero-round apply: one round each
    check(m7_counts["k1_phase"] == 2 * steps7 + 1
          and m7_counts["k1_rounds"] == 2 * steps7 + 1,
          f"mode 7: K1 {m7_counts['k1_phase']} launches, "
          f"{m7_counts['k1_rounds']} rounds for {steps7} steps")
    check(all(b < a for a, b in zip(m7_out["residual_history"],
                                    m7_out["residual_history"][1:])),
          "mode 7: the explicit run does not stay bounded at dt 5e-8")
    for ref_name, ref in (("plain CPU", m7_cpu), ("JAX CPU", MODE7_CLI)):
        hold_to("mode 7", m7_out, ref, ref_name, 1e-3, "residual_history")
        hold_to("mode 7", m7_out, ref, ref_name, 1e-3, "L1_error")

    # 18. BiCGStab: mode 9 with advection and --krylov on the geometric CLI
    # path (221,184 DOF) --------------------------------------------------
    bi_out, bi_counts = drive(BICGSTAB_ARGS)
    bi_cpu = cli.main(BICGSTAB_ARGS + ["--device", "cpu"])
    say("main", path="mode9_bicgstab", launches=bi_counts,
        krylov_iterations=bi_out["krylov_iterations"],
        cpu_krylov_iterations=bi_cpu["krylov_iterations"],
        jax_krylov_iterations=BICGSTAB_CLI["krylov_iterations"],
        residual_history=bi_out["residual_history"],
        cpu=bi_cpu["residual_history"],
        jax_cpu=BICGSTAB_CLI["residual_history"], L1_error=bi_out["L1_error"],
        cpu_L1_error=bi_cpu["L1_error"],
        jax_L1_error=BICGSTAB_CLI["L1_error"], wall_s=bi_out["wall_s"])
    check(all(it > 2 for it in bi_out["krylov_iterations"]),
          "BiCGStab took 2 iterations or fewer a step")
    for ref_name, ref in (("plain CPU", bi_cpu), ("JAX CPU", BICGSTAB_CLI)):
        # f32 evaluation order moves a Krylov count at a 1e-6 stop by one
        check(all(abs(a - b) <= 1 for a, b in zip(
            bi_out["krylov_iterations"], ref["krylov_iterations"])),
            f"BiCGStab iterations {bi_out['krylov_iterations']}, "
            f"{ref_name} {ref['krylov_iterations']}")
        # the port's plain path and JAX (f32) differed by 6.1e-5 in L1 and
        # 0.2% in the residuals, which sit at the 1e-6 stop
        hold_to("BiCGStab", bi_out, ref, ref_name, 5e-4, "L1_error")
        hold_to("BiCGStab", bi_out, ref, ref_name, 0.05, "residual_history")

    # 19. Crank-Nicolson: mode 9 with --theta 0.5 --------------------------
    th_out, th_counts = drive(THETA_ARGS)
    say("main", path="mode9_theta_half", launches=th_counts,
        residual_history=th_out["residual_history"], jax_cpu=THETA_HISTORY,
        L1_error=th_out["L1_error"], wall_s=th_out["wall_s"])
    hold_to("theta 1/2", th_out, {"residual_history": THETA_HISTORY},
            "JAX CPU", 0.01, "residual_history")

    # 20. mode 6 at n_split 0 (C = 1): painted_mesh(256) as a gmsh file,
    # 131,072 elements, 393,216 DOF, Crank-Nicolson advection-diffusion by
    # BiCGStab; K1 at C = 1, U = 131,072, a shape no other path gives it --
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for n in (MODE6_N, MODE6_SMALL_N):
            paths[n] = f"{tmp}/painted_{n}.msh"
            gmsh.write_msh(paths[n], painted_mesh(n))
        m6 = transport_solver(dev, gmsh_mesh(paths[MODE6_N]))
        op6 = m6.ops[0]
        check((op6.C, op6.U, op6.nb) == (1, 131072, 3),
              f"mode 6: K1 level {(op6.C, op6.U, op6.nb)}")
        x6, b6 = rand(op6), rand(op6)
        coefs6 = m6._phase_coefs(0, m6.cfg.n_smooth)
        k1_dg_err = max(
            k1_parity("mode6_cheb12_z", op6, x6, op6._bp(b6, True), coefs6,
                      True, 1e-4),
            k1_parity("mode6_apply", op6, x6, torch.zeros_like(x6), [],
                      True, 1e-5))
        m6_argv = MODE6_ARGS + ["--mesh", paths[MODE6_N]]
        m6_out, m6_counts, T6, m6_run = drive_state(m6_argv)
        f32_ref["mode6"] = (m6_counts, list(m6_run.krylov_iters),
                            unit_counts(m6), krylov_drop(m6))
        T6_t = to_t(m6.initial_condition())
        m6._step_t(T6_t)
        m6.krylov_iters.clear()
        m6_ms = event_ms(lambda: m6._step_t(T6_t), 3)
        say("main", path="mode6", launches=m6_counts,
            elements=m6_out["elements"], tier=K.KERNEL.plan(op6).tier,
            krylov_iterations=m6_run.krylov_iters,
            step_krylov_iterations=m6.krylov_iters[:1],
            ms_per_step=f"{m6_ms:.4f}", T_max=float(T6.abs().max()),
            wall_s=m6_out["wall_s"], card=repr(card))
        check(m6_out["elements"] == 131072 and m6_counts["k1_phase"] > 0,
              f"mode 6: {m6_counts}")
        check(bool(torch.isfinite(T6).all()) and float(T6.abs().max()) < 1.5,
              "mode 6: the state is not finite and bounded")
        small = MODE6_ARGS + ["--mesh", paths[MODE6_SMALL_N]]
        s_out, _, Ts, s_run = drive_state(small)
        c_out, Tc, c_run = cli.run(small + ["--device", "cpu"])
        diff6 = float((Ts.cpu() - Tc).abs().max())
        say("main", path="mode6_small", elements=s_out["elements"],
            krylov_iterations=s_run.krylov_iters,
            cpu_krylov_iterations=c_run.krylov_iters,
            max_abs_diff_cpu=f"{diff6:.3e}", T_max=float(Tc.abs().max()))
        # both BiCGStab runs stop at a 1e-8 drop, after other iterates in
        # f32 (63 and 61 iterations on the H100 80GB HBM3, 65 and 62 on
        # the CPU): the states differed by 8.9e-6 (max |T| 0.73), so 5e-5
        check(diff6 <= 5e-5, f"mode 6 (64 x 64) differs from the plain CPU "
              f"path by {diff6:.3e}")
    bp6 = op6._bp(b6, True)
    n_before = K.KERNEL.launches
    k1_dg_ms, k1_dg_plain_ms, times = time_pair(
        lambda: K.phase(op6, x6, bp6, coefs6, True),
        lambda: K.phase_reference(op6, x6, bp6, coefs6, True), 20)
    check(K.KERNEL.launches - n_before == 43,
          "timed C = 1 phases did not launch K1 once each")
    k1_dg_bound = bound_ms(least_bytes(op6))
    say("time", phase="mode6_cheb12_z", C=op6.C, U=op6.U,
        tier=K.KERNEL.plan(op6).tier, k1_ms=f"{k1_dg_ms:.4f}",
        plain_ms=f"{k1_dg_plain_ms:.4f}", bound_ms=f"{k1_dg_bound:.4f}",
        least_MB=f"{least_bytes(op6) / 1e6:.2f}",
        k1_runs=[f"{v:.4f}" for v in times["kernel"]],
        plain_runs=[f"{v:.4f}" for v in times["plain"]], card=repr(card))
    del m6, m6_run, op6

    # 21. the erfc breakthrough gate on the card: the generated 60 x 3
    # strip, Crank-Nicolson, u = (1, 0), 40 steps, Rannacher start, no-flux
    # walls (tests/test_transport.py:46-70) -------------------------------
    setup = transport.BreakthroughSetup()
    strip = structured.tri_mesh(60, 3, 2.0 / 60, 0.1 / 3)
    gate_cfg = transport.TransportConfig(
        ntime=40, dt=setup.t_end / 40, u=(1.0, 0.0), k=1.0, diffusion=True,
        implicit=True, theta=0.5)
    counts_zero()
    t0 = time.time()
    g_solver, Tg = transport.solve(strip, gate_cfg, transport.breakthrough_fns(
        setup, x_len=2.0), device=dev)
    torch.cuda.synchronize()
    g_counts, g_s = read_counts(), time.time() - t0
    coords = splitting.child_coords(strip.X, 0).reshape(-1, 2, 3)
    xs, sampled = probe.line_probe(coords, Tg.cpu().numpy().reshape(-1, 3),
                                   y=0.0333, x0=0.0, x1=1.0, n=202)
    g = gates.check(sampled, analytical.breakthrough_erfc(xs, setup.t_end,
                                                          setup.gamma))
    say("gate", check="erfc_breakthrough", launches=g_counts, gate=str(g),
        inlet=float(sampled[0]), krylov_iterations=g_solver.krylov_iters,
        seconds=f"{g_s:.2f}")
    check(g_counts["k1_phase"] > 0, "the erfc gate launched K1 no time")
    check(g.passed and abs(sampled[0] - 1.0) < 0.01,
          f"erfc gate on the card: {g}, inlet {sampled[0]}")

    # 22. (a) the reference's active mode-9 configuration at 393,216 DOF:
    # point Jacobi (omega 0.8), no surface terms, the corner-average
    # restrictor, 6 V-cycles a step.  Every operator apply is a zero-round
    # K1 launch; the 98,304-DOF coarsest continues into SA levels (K2) ---
    def step_ms(sv, reps=3):
        """ms a time step of sv from T0 by CUDA events (after one step),
        and the K1 / K2 launches and K1 rounds of one step."""
        T0_t = to_t(sv.initial_condition())
        sv._step_t(T0_t)
        counts_zero()
        sv._step_t(T0_t)
        torch.cuda.synchronize()
        c = read_counts()
        return event_ms(lambda: sv._step_t(T0_t), reps), c

    a_out, a_counts, _, a_sv = drive_state(REFERENCE9_ARGS)
    # the zero-round apply's launches on its own path, the CLI's two steps
    # (108 a step) and the three applies of the CLI's setup and result
    apply_launches = a_counts["k1_phase"]
    a_cpu = cli.main(REFERENCE9_ARGS + ["--device", "cpu"])
    check([(op.C, op.U) for op in a_sv.ops] == [(16, 8192), (4, 8192)]
          and a_sv.agg is not None and a_sv._agg_li == 1
          and not a_sv.phase_cycle,
          "reference mode 9: not point Jacobi on 2 levels with SA below")
    # the menu smoothers' operator: the zero-round apply on each level
    apply_err = max(k1_parity(*case)
                    for case in solver_cases("ref9", a_sv, phases=False))
    k2_err = max(k2_err, k2_parity("ref9", a_sv.agg.rowops()))
    a_ms, a_step = step_ms(a_sv)
    check(a_step["k1_phase"] == 108 and apply_launches == 219,
          f"reference mode 9: {apply_launches} zero-round applies, "
          f"{a_step['k1_phase']} a step, not 219 and 108")
    say("main", path="mode9_reference_jacobi", launches=a_counts,
        step_launches=a_step, ms_per_step=f"{a_ms:.4f}",
        sa_levels=[lv.n for lv in a_sv.agg.levels],
        residual_history=a_out["residual_history"],
        cpu=a_cpu["residual_history"],
        jax_cpu=REFERENCE9_CLI["residual_history"],
        L1_error=a_out["L1_error"], cpu_L1_error=a_cpu["L1_error"],
        jax_L1_error=REFERENCE9_CLI["L1_error"], wall_s=a_out["wall_s"],
        cpu_wall_s=a_cpu["wall_s"], card=repr(card))
    check(a_counts["k1_phase"] > 0 and a_counts["k2_rowop"] > 0,
          f"reference mode 9 did not launch both kernels: {a_counts}")
    check(a_counts["k1_rounds"] == a_counts["k1_phase"],
          "reference mode 9: a K1 launch that was not a zero-round apply")
    # the residual (5.1e-6) is no f32 floor: f64 gives the same to 1e-6,
    # and the port's CPU run and JAX (f32) agree to 1.2e-6 relative
    for ref_name, ref in (("plain CPU", a_cpu), ("JAX CPU", REFERENCE9_CLI)):
        hold_to("reference mode 9", a_out, ref, ref_name, 0.02,
                "residual_history")
        hold_to("reference mode 9", a_out, ref, ref_name, 1e-4, "L1_error")
    # the zero-round apply (the menu's operator) on both levels, timed
    # against its plain version and against the library call that computes
    # the same z = -D^-1 A x (cuSPARSE's BSR product over the premultiplied
    # blocks); its bound counts the coupling blocks, x in and z out
    ka = []
    for li, op in enumerate(a_sv.ops):
        x = rand(op)
        zeros = torch.zeros_like(x)
        n_before = K.KERNEL.launches
        ms, plain_ms, times = time_pair(
            lambda: K.phase(op, x, zeros, [], True),
            lambda: K.phase_reference(op, x, zeros, [], True), 50)
        check(K.KERNEL.launches - n_before == 103,
              "timed zero-round applies did not launch K1 once each")
        A, xv = stencil_bsr_matrix(op), x.reshape(3, -1).T.reshape(-1)
        lib_z = (A @ xv).reshape(-1, 3).T.reshape(x.shape)
        lib_err = float((lib_z - K.phase(op, x, zeros, [], True)[1])
                        .abs().max())
        check(lib_err <= 1e-5 * float(lib_z.abs().max()),
              f"ref9_apply_l{li}: the BSR yardstick differs from K1 by "
              f"{lib_err:.3e}")
        for _ in range(3):
            A @ xv
        lib_ms = event_ms(lambda: A @ xv, 50)
        backend = sorted({k for k, _, _ in _trace(lambda: A @ xv, 5)})
        nbytes = least_bytes(op, planes=2)
        ka.append((ms, plain_ms, bound_ms(nbytes), lib_ms))
        say("time", phase=f"ref9_apply_l{li}", C=op.C, U=op.U,
            tier=K.KERNEL.plan(op).tier, k1_ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", bound_ms=f"{ka[li][2]:.5f}",
            least_MB=f"{nbytes / 1e6:.2f}", library_ms=f"{lib_ms:.5f}",
            library_kernels=backend, library_max_abs_err=f"{lib_err:.3e}",
            k1_runs=[f"{v:.5f}" for v in times["kernel"]],
            plain_runs=[f"{v:.5f}" for v in times["plain"]], card=repr(card))
    del a_sv, op, A

    # 23. (b) colored Gauss-Seidel and Richardson with surface terms on the
    # geometric CLI path (221,184 DOF); GS makes two zero-round applies a
    # sweep, one a color ---------------------------------------------------
    menu_ms = {}
    for name, argv, want in (("gauss_seidel", GS_ARGS, GS_CLI),
                             ("richardson", RICHARDSON_ARGS,
                              RICHARDSON_CLI)):
        m_out, m_counts, _, m_sv = drive_state(argv)
        menu_ms[name], m_step = step_ms(m_sv)
        say("main", path=f"mode9_{name}", launches=m_counts,
            step_launches=m_step, ms_per_step=f"{menu_ms[name]:.4f}",
            residual_history=m_out["residual_history"],
            jax_cpu=want["residual_history"], L1_error=m_out["L1_error"],
            jax_L1_error=want["L1_error"], wall_s=m_out["wall_s"],
            card=repr(card))
        check(m_counts["k1_phase"] > 0 and m_counts["k2_rowop"] == 0
              and m_counts["k1_rounds"] == m_counts["k1_phase"],
              f"{name}: not zero-round K1 applies alone: {m_counts}")
        hold_to(name, m_out, want, "JAX CPU", 0.02, "residual_history")
        hold_to(name, m_out, want, "JAX CPU", 1e-4, "L1_error")
        del m_sv
    states = {}
    for name in ("jacobi", "direct"):
        states[name] = cli.run(DIRECT_SMALL_ARGS + [
            "--solver", name, "--device", "cuda"])[1]
    say("main", path="mode9_direct_vs_jacobi",
        equal=bool(torch.equal(states["jacobi"], states["direct"])))
    check(torch.equal(states["jacobi"], states["direct"]),
          "--solver direct differs from --solver jacobi on the card")

    # 24. (c) the non-stencil path at n_split 7: 8 macros of C = 16,384
    # (393,216 DOF), Chebyshev through the fused operator, the 24,576-DOF
    # coarsest by coarse sweeps.  On the TPU this path ran XLA alone: no K1
    # and no K2 launch here either --------------------------------------
    t0 = time.time()
    ns_sv = cli_solver(dev, NSPLIT7_ARGS)
    torch.cuda.synchronize()
    ns_setup = time.time() - t0
    check(not ns_sv.stencil and ns_sv.fused is not None
          and [lv["C"] for lv in ns_sv.p.levels] == [16384, 4096, 1024]
          and ns_sv.coarse_inv_t is None and ns_sv.agg is None,
          "n_split 7: not the fused three-level path with coarse sweeps")
    ns_ms, ns_step = step_ms(ns_sv)
    del ns_sv
    ns_out, ns_counts = drive(NSPLIT7_ARGS)
    ns_cpu = cli.main(NSPLIT7_ARGS + ["--device", "cpu"])
    say("main", path="mode9_n_split7", launches=ns_counts,
        step_launches=ns_step, setup_seconds=f"{ns_setup:.2f}",
        ms_per_step=f"{ns_ms:.4f}",
        residual_history=ns_out["residual_history"],
        cpu=ns_cpu["residual_history"],
        jax_cpu=NSPLIT7_CLI["residual_history"],
        L1_error=ns_out["L1_error"], cpu_L1_error=ns_cpu["L1_error"],
        jax_L1_error=NSPLIT7_CLI["L1_error"], wall_s=ns_out["wall_s"],
        cpu_wall_s=ns_cpu["wall_s"], card=repr(card))
    check(ns_counts["k1_phase"] == 0 and ns_counts["k2_rowop"] == 0,
          f"n_split 7 launched a kernel: {ns_counts}")
    for ref_name, ref in (("plain CPU", ns_cpu), ("JAX CPU", NSPLIT7_CLI)):
        hold_to("n_split 7", ns_out, ref, ref_name, 0.02,
                "residual_history")
        hold_to("n_split 7", ns_out, ref, ref_name, 1e-4, "L1_error")

    # 25. (d) the stencil probed from apply_A (float64, on the host) at the
    # bench size: its blocks against the closed form on the same tables in
    # float64, its K1 phases against the plain version, and one V-cycle
    # through K1 against the analytic stencil's ---------------------------
    t0 = time.time()
    probed = bench_solver(dev, stencil_probe=True)
    probe_s = time.time() - t0
    fields = ("self_blocks", "face_blocks", "cross_blocks", "c_aff")
    probe_err = 0.0
    for li, (op, L) in enumerate(zip(probed.ops, probed.p.levels)):
        L64 = {k: (v.astype(np.float64) if isinstance(v, np.ndarray)
                   and v.dtype.kind == "f" else v) for k, v in L.items()}
        exact = stencil.build_stencil(L64, probed.cfg.physics,
                                      probed.cfg.dt, probed.cfg.theta)
        for f in fields:
            want = getattr(exact, f)
            err = float(np.abs(getattr(op._data, f) - want).max())
            probe_err = max(probe_err, err / max(float(np.abs(want).max()),
                                                 1e-300))
    check(probe_err <= 1e-10, f"probed blocks differ from the closed form "
          f"by {probe_err:.3e} relative")
    x_p = to_t(probed.initial_condition())
    b_p = probed._rhs_t(x_p)
    probe_k1 = max(k1_parity(*case)
                   for case in solver_cases("probe", probed))
    max_abs_err = max(max_abs_err, probe_k1)
    counts_zero()
    cyc_p = probed._vcycle_t(0, x_p, b_p)
    torch.cuda.synchronize()
    p_counts = read_counts()
    cyc_a = solver._vcycle_t(0, x_p, solver._rhs_t(x_p))
    cyc_diff = float((cyc_p - cyc_a).abs().max())
    cyc_scale = float(cyc_a.abs().max())
    say("main", path="stencil_probe", probe_seconds=f"{probe_s:.2f}",
        levels=[(op.C, op.U) for op in probed.ops],
        blocks_rel_err=f"{probe_err:.3e}", cycle_launches=p_counts,
        cycle_max_abs_diff=f"{cyc_diff:.3e}", cycle_max=f"{cyc_scale:.3e}",
        lam_max=[f"{v:.6g}" for v in probed._lam_max],
        analytic_lam_max=[f"{v:.6g}" for v in solver._lam_max])
    check(p_counts["k1_phase"] > 0, "the probed V-cycle launched K1 no time")
    # f32 blocks rounded from the probe and from the closed form, and
    # lam_max from each: one cycle agrees to f32 rounding
    check(cyc_diff <= 1e-5 * cyc_scale, f"probed V-cycle differs from the "
          f"analytic one by {cyc_diff:.3e} (max {cyc_scale:.3e})")
    del probed

    # 26. (e) mode 1 (plain PyTorch, no kernel): the reference's 200 x 1
    # quads and 200 x 1024 at width, 714 steps each, against JAX's t_range,
    # the moving box's centre of mass and mass, and at width the first
    # MODE1_CPU_STEPS steps against the port's plain path on the CPU -----
    def box_gates(name, out, problem, T):
        """t_range against JAX; the centre of mass moved by u*t and the
        mass kept, within MODE1_GATE relative (float64 sums)."""
        cfg = problem.cfg
        T = T.double().cpu().numpy()
        T0 = transport_rect.initial_condition(problem).double().cpu().numpy()
        xs = problem.x_all[:, 0, :]
        shift = cfg.u[0] * out["dt"] * out["ntime"]
        com_err = ((xs * T).sum() / T.sum() - (xs * T0).sum() / T0.sum()
                   - shift) / shift
        mass_err = (T.sum() - T0.sum()) / T0.sum()
        say("main", path=name, com_rel_err=f"{com_err:.3e}",
            mass_rel_err=f"{mass_err:.3e}", ntime=out["ntime"], dt=out["dt"],
            t_range=out["t_range"], jax_t_range=MODE1_CLI["t_range"],
            wall_s=out["wall_s"])
        check(out["ntime"] == MODE1_CLI["ntime"]
              and out["dt"] == MODE1_CLI["dt"], f"{name}: ntime / dt")
        hold_to(name, out, MODE1_CLI, "JAX CPU", 1e-5, "t_range")
        check(abs(com_err) <= MODE1_GATE and abs(mass_err) <= MODE1_GATE,
              f"{name}: centre of mass {com_err:.3e}, mass {mass_err:.3e}")

    r_out, r_counts, T_r, p_r = drive_state(MODE1_REF_ARGS)
    box_gates("mode1_reference", r_out, p_r, T_r)
    w_out, w_counts, T_w, p_w = drive_state(MODE1_ARGS)
    box_gates("mode1_width", w_out, p_w, T_w)
    check(r_counts["k1_phase"] == r_counts["k2_rowop"] == 0
          and w_counts["k1_phase"] == w_counts["k2_rowop"] == 0,
          f"mode 1 launched a kernel: {r_counts}, {w_counts}")
    del T_w, p_w
    cfg_w = RectConfig(no_ele_row=200, no_ele_col=1024)
    T_gpu = transport_rect.solve(cfg_w, dev, ntime=MODE1_CPU_STEPS)[1]
    T_cpu = transport_rect.solve(cfg_w, "cpu", ntime=MODE1_CPU_STEPS)[1]
    m1_diff = float((T_gpu.cpu() - T_cpu).abs().max())
    step1, T1_0 = rect_step(dev)
    step1(T1_0)
    m1_ms = event_ms(lambda: step1(T1_0), 20)
    say("main", path="mode1_width_cpu", steps=MODE1_CPU_STEPS,
        max_abs_diff_cpu=f"{m1_diff:.3e}", max_T=float(T_cpu.abs().max()),
        dof=T1_0.numel(), ms_per_step=f"{m1_ms:.4f}", card=repr(card))
    check(m1_diff <= 1e-5 * float(T_cpu.abs().max()),
          f"mode 1 width: {m1_diff:.3e} from the plain CPU path")
    del T_gpu, T_cpu

    # 27. this slice's main path: a user-defined problem through the CLI at
    # 393,216 DOF (--ic/--bc/--source/--analytical), geometric and with
    # --amg --krylov, each against the built-in manufactured problem (the
    # same numbers bit for bit, the same launches) ---------------------------
    user = {}
    for name, extra in (("geometric", []), ("amg_krylov",
                                            ["--amg", "--krylov"])):
        runs = [drive_state(USER_BASE + extra + e)
                for e in ([], USER_EXPR)]
        (ob, cb, Tb, _), (oe, ce, Te, sve) = runs
        say("main", path=f"user_{name}", launches=ce,
            residual_history=oe["residual_history"],
            krylov_iterations=oe.get("krylov_iterations"),
            L1_error=oe["L1_error"], wall_s=oe["wall_s"],
            builtin_wall_s=ob["wall_s"])
        check(torch.equal(Tb, Te), f"user {name}: the expression problem's "
              f"state differs from the built-in one's by "
              f"{float((Tb - Te).abs().max()):.3e}")
        check(all(ob[k] == oe[k] for k in ("residual_history", "L1_error",
                                           "residual")),
              f"user {name}: {oe} != built-in {ob}")
        check(cb == ce, f"user {name}: launches {ce}, built-in {cb}")
        check(ce["k1_phase"] > 0 and (name == "geometric"
                                      or ce["k2_rowop"] > 0),
              f"user {name}: launches {ce}")
        user[name] = (oe, ce, Te)
        del runs, Tb, sve
    # the expressions' host evaluation at the 393,216 fine nodes: the ones
    # above and erf (np.vectorize(math.erf), point by point, as in JAX)
    cf = structured.tri_mesh(128, 32, 3 / 128, 1 / 128)
    cf = splitting.child_coords(cf.X, 2)
    xf, yf = cf[:, :, 0], cf[:, :, 1]
    for text in ("sin(x+y)", "2*sin(x+y)", "erf(x-y)"):
        t0 = time.perf_counter()
        val = Expression(text)(xf, yf)
        say("setup", expression=repr(text), points=val.size,
            seconds=f"{time.perf_counter() - t0:.3f}")
    del cf, xf, yf, val

    pins = pins_mod.load_pins()
    with tempfile.TemporaryDirectory() as tmp:
        # 28. a .geo domain: the annulus meshed by mesh_geo (2,048 macros,
        # 393,216 DOF at n_split 3, C = 64: K1), PCG through the CLI; its
        # V-cycle history held to the JAX package's pin on the same mesh
        geo_path = f"{tmp}/annulus.geo"
        with open(geo_path, "w") as f:
            f.write(pins_mod.ANNULUS_GEO)
        pin = pins["annulus_geo:s3:cli"]
        t0 = time.perf_counter()
        ann = geo_mesh.mesh_geo(geo_path)
        geo_s = time.perf_counter() - t0
        check(pins_mod.mesh_hash(ann) == pin["x_hash"],
              f"the annulus .geo meshed to X hash {pins_mod.mesh_hash(ann)} "
              f"({ann.num_elements} macros) in this run, the JAX pin's is "
              f"{pin['x_hash']} ({pin['num_macro']} macros): scipy's "
              f"Delaunay differs here, so the pin is of another mesh")
        ann_args = pins_mod.CLI_ARGS + ["--mesh", geo_path, "--n-split", "3"]
        t0 = time.perf_counter()
        ann_sv = cli.setup(ann_args + ["--device", "cuda"])[2]
        torch.cuda.synchronize()
        ann_setup_s = time.perf_counter() - t0
        counts_zero()
        ann_hist = pins_mod.residual_history(ann_sv,
                                             len(pin["residual_linf"]))
        torch.cuda.synchronize()
        f32_ref["annulus_geo:s3:cli"] = read_counts()
        fails = pins_mod.hold(ann_hist, pin)
        say("pin", spec="annulus_geo:s3:cli",
            residual_linf=[f"{v:.4e}" for v in ann_hist],
            jax_f64=[f"{v:.4e}" for v in pin["residual_linf"]],
            f32_floor=pin["f32_floor"], fails=fails)
        check(not fails, f"annulus history against its pin: {fails}")
        del ann_sv
        ann_out, ann_counts, T_ann, ann_sv = drive_state(ann_args)
        f32_ref["annulus_cli"] = (ann_counts, ann_out["krylov_iterations"],
                                  unit_counts(ann_sv))
        T_t = to_t(T_ann)
        ann_ms = event_ms(lambda: ann_sv._step_t(T_t), 3)
        say("main", path="geo_annulus", macros=ann.num_elements,
            dof=T_ann.numel(), mesh_geo_s=f"{geo_s:.3f}",
            setup_s=f"{ann_setup_s:.2f}", ms_per_step=f"{ann_ms:.3f}",
            launches=ann_counts,
            residual_history=ann_out["residual_history"],
            krylov_iterations=ann_out["krylov_iterations"],
            L1_error=ann_out["L1_error"], wall_s=ann_out["wall_s"],
            card=repr(card))
        check(ann_out["elements"] == pin["num_macro"] == 2048
              and ann_counts["k1_phase"] > 0
              and all(math.isfinite(v)
                      for v in ann_out["residual_history"]),
              f"annulus CLI: {ann_out}, {ann_counts}")
        del T_ann, ann_sv, T_t, ann

        # 29. the history pins on the card, float32, each held to the JAX
        # package's float64 pin within 2% plus twice its float32 floor:
        # the bench stand-in (levels 1, 2), the .geo square at n_split 4
        # (C = 256: K1 in the TPU's K3 regime, launches_deep) and the amg
        # production pins (K2)
        for spec in pins_mod.DEFAULT_SPECS:
            name, n_split, levels = spec
            if levels == "cli":
                continue
            key = pins_mod.spec_key(*spec)
            pin = pins[key]
            mesh = pins_mod.spec_mesh(name, levels)
            check(pins_mod.mesh_hash(mesh) == pin["x_hash"],
                  f"{key}: the stand-in's X hash {pins_mod.mesh_hash(mesh)} "
                  f"is not the pin's {pin['x_hash']}")
            p_sv = semi.SemiSolver(semi.build_problem(
                mesh, pins_mod.spec_config(n_split, levels)), dev)
            counts_zero()
            got = pins_mod.residual_history(p_sv, len(pin["residual_linf"]))
            torch.cuda.synchronize()
            c = f32_ref[key] = read_counts()
            fails = pins_mod.hold(got, pin)
            say("pin", spec=key, k1=c["k1_phase"], k1_deep=c["k1_deep"],
                k2=c["k2_rowop"], residual_linf=[f"{v:.4e}" for v in got],
                jax_f64=[f"{v:.4e}" for v in pin["residual_linf"]],
                f32_floor=pin["f32_floor"], fails=fails)
            check(not fails, f"{key} against its pin: {fails}")
            check(c["k1_phase"] > 0 and (c["k1_deep"] > 0) == (n_split >= 4)
                  and (c["k2_rowop"] > 0 or levels != "amg"),
                  f"{key}: launches {c}")
            del p_sv

        # 30. checkpoint and VTU at full width on the user problem: 4 steps
        # straight against 2 steps, a checkpoint and a resume to 4 (K1 and
        # K2 add in a fixed order: the same bits); a --vtk-interval 2 series
        # whose Tracer arrays hold the states on the host
        ck = f"{tmp}/user.npz"
        f_out, _, T4, _ = drive_state(USER_ARGS + ["--ntime", "4"])
        c_out = drive_state(USER_ARGS + ["--ntime", "2", "--checkpoint", ck,
                                         "--checkpoint-every", "2"])[0]
        r_out, _, T4r, _ = drive_state(USER_ARGS + [
            "--ntime", "4", "--checkpoint", ck, "--checkpoint-every", "2"])
        say("main", path="checkpoint", resumed_from_step=r_out.get(
            "resumed_from_step"), straight=f_out["residual_history"],
            first=c_out["residual_history"],
            resumed=r_out["residual_history"],
            max_abs_diff=f"{float((T4 - T4r).abs().max()):.3e}")
        check(r_out.get("resumed_from_step") == 2
              and c_out["residual_history"] + r_out["residual_history"]
              == f_out["residual_history"] and torch.equal(T4, T4r),
              "the resumed run differs from the straight one")
        del T4, T4r
        spent = []
        write_vtu = vtu_mod.write_vtu

        def timed_write(*a, **kw):
            t0 = time.perf_counter()
            write_vtu(*a, **kw)
            spent.append(time.perf_counter() - t0)

        vtu_mod.write_vtu = timed_write
        try:
            v_out, _, T_v, _ = drive_state(USER_ARGS + [
                "--vtu", f"{tmp}/user.vtu", "--vtk-interval", "2"])
        finally:
            vtu_mod.write_vtu = write_vtu
        series = v_out["vtu_series"]

        def tracer(path):
            with open(path) as f:
                lines = f.read().splitlines()
            at = next(i for i, ln in enumerate(lines) if 'Name="Tracer"' in ln)
            return np.asarray(lines[at + 1].split(), np.float64)

        host = T_v.cpu().numpy().reshape(-1)
        want = np.asarray(["%.7g" % v for v in host], np.float64)
        check(len(series) == 2 and [p[-9:] for p in series]
              == ["_0000.vtu", "_0002.vtu"], f"series {series}")
        check(np.array_equal(tracer(series[-1]), want)
              and np.array_equal(tracer(v_out["vtu"]), want)
              and not tracer(series[0]).any(),
              "a VTU file's Tracer is not the state on the host")
        say("main", path="vtu", files=len(spent), points=host.size,
            write_s=[f"{t:.2f}" for t in spent],
            wall_s=v_out["wall_s"])
        del T_v, host, want

    # 31. the sanitizer (--debug): the checked builds of K1 and K2 ---------
    # (a) the CLI main path with --debug on the user problem with --amg
    # --krylov: only checked launches, as many as the unchecked run's, and
    # the same bits
    d_out, d_counts, T_d, d_sv = drive_state(USER_ARGS + [
        "--amg", "--krylov", "--debug"])
    u_out, u_counts, T_u = user["amg_krylov"]
    say("main", path="user_amg_krylov_debug", launches=d_counts,
        residual_history=d_out["residual_history"],
        unchecked_launches=u_counts, wall_s=d_out["wall_s"],
        unchecked_wall_s=u_out["wall_s"])
    check(d_counts["k1_phase"] == d_counts["k2_rowop"] == 0
          and d_counts["k1_checked"] == u_counts["k1_phase"] > 0
          and d_counts["k1_checked_rounds"] == u_counts["k1_rounds"]
          and d_counts["k2_checked"] == u_counts["k2_rowop"] > 0,
          f"checked launches {d_counts}, unchecked {u_counts}")
    check(torch.equal(T_d, T_u) and all(
        d_out[k] == u_out[k] for k in ("residual_history", "L1_error",
                                       "krylov_iterations")),
          "the checked CLI run differs from the unchecked one")
    main_checked = d_counts
    del T_d, d_sv, T_u
    # (b) the bench-geometric and production amg configurations: 10 cycles
    # unchecked, then checked (the step made checked as SemiConfig(debug=
    # True) makes it at the end of the constructor): the same histories and
    # launches
    for name, sv in (("bench", solver), ("amg", amg)):
        counts_zero()
        h_u = history(sv)
        c_u = read_counts()
        sv._make_checked("_step_t")
        counts_zero()
        h_c = history(sv)
        sv.sanitizer.raise_on_fault()
        c_c = read_counts()
        say("sanitizer", config=name, unchecked=c_u, checked=c_c,
            identical=h_u == h_c)
        check(h_u == h_c, f"{name}: checked history {h_c} != {h_u}")
        check(c_c["k1_phase"] == c_c["k2_rowop"] == 0
              and (c_c["k1_checked"], c_c["k1_checked_rounds"],
                   c_c["k2_checked"])
              == (c_u["k1_phase"], c_u["k1_rounds"], c_u["k2_rowop"]),
              f"{name}: checked launches {c_c}, unchecked {c_u}")
    # (c) device time of the fine K1 phase (C = 16, U = 8192) and of K2 on
    # l0_op, checked against unchecked, in turns; and each against its
    # plain version on the same inputs
    site0 = op0.sanitizer
    coefs0 = solver._phase_coefs(0, solver.cfg.n_smooth)
    xk1, bpk1 = rand(op0), op0._bp(rand(op0), True)

    def k1_run(checked):
        op0.sanitizer = site0 if checked else None
        return K.phase(op0, xk1, bpk1, coefs0, True)

    xc, zc = k1_run(True)
    xu, zu = k1_run(False)
    xr, zr = K.phase_reference(op0, xk1, bpk1, coefs0, True)
    k1c_err = max(float((xc - xr).abs().max()), float((zc - zr).abs().max()))
    check(torch.equal(xc, xu) and torch.equal(zc, zu),
          "checked K1 differs from unchecked K1")
    check(k1c_err <= 1e-4 * float(xr.abs().max()),
          f"checked K1 against its plain version: {k1c_err:.3e}")
    k1c_ms, k1u_ms, k1_times = time_pair(lambda: k1_run(True),
                                         lambda: k1_run(False), 20)
    op0.sanitizer = site0
    l0 = rowops["l0_op"]
    site2 = l0.sanitizer
    xl = torch.as_tensor(rng.normal(size=(3, l0.n_src)).astype(np.float32),
                         device=dev)

    def k2_run(checked):
        l0.sanitizer = site2 if checked else None
        return l0(xl)

    yc, yu = k2_run(True), k2_run(False)
    k2c_err = float((yc - K2.rowop_reference(*l0.tables(), xl)).abs().max())
    check(torch.equal(yc, yu), "checked K2 differs from unchecked K2")
    k2c_ms, k2u_ms, k2_times = time_pair(lambda: k2_run(True),
                                         lambda: k2_run(False), 50)

    def device_us(fn, cls, reps):
        """Device time of one call's ``cls`` kernels, torch.profiler."""
        ks = [k for k in _trace(fn, reps) if kernel_class(k[0]) == cls]
        return sum(d for _, _, d in ks) / reps

    # in turns: unchecked, checked, checked, unchecked
    dev_us = {}
    for key, fn, cls, reps in (
            ("k1u", lambda: k1_run(False), "k1_phase", 20),
            ("k1c", lambda: k1_run(True), "k1_phase", 20),
            ("k1c", lambda: k1_run(True), "k1_phase", 20),
            ("k1u", lambda: k1_run(False), "k1_phase", 20),
            ("k2u", lambda: k2_run(False), "k2_rowop", 50),
            ("k2c", lambda: k2_run(True), "k2_rowop", 50),
            ("k2c", lambda: k2_run(True), "k2_rowop", 50),
            ("k2u", lambda: k2_run(False), "k2_rowop", 50)):
        dev_us.setdefault(key, []).append(device_us(fn, cls, reps))
    op0.sanitizer = site0
    l0.sanitizer = site2
    solver.sanitizer.raise_on_fault()
    amg.sanitizer.raise_on_fault()
    say("time", phase="fine_cheb6_z_checked", C=op0.C, U=op0.U,
        tier=K.CHECKED.plan(op0).tier,
        device_us_checked=[f"{v:.2f}" for v in dev_us["k1c"]],
        device_us_unchecked=[f"{v:.2f}" for v in dev_us["k1u"]],
        events_us_checked=f"{1e3 * k1c_ms:.2f}",
        events_us_unchecked=f"{1e3 * k1u_ms:.2f}",
        bound_us=f"{1e3 * k1_bound:.2f}", max_abs_err=f"{k1c_err:.3e}",
        card=repr(card))
    say("time", rowop="l0_op_checked", N=l0.n_out, D=l0.D,
        variant=l0.variant,
        device_us_checked=[f"{v:.2f}" for v in dev_us["k2c"]],
        device_us_unchecked=[f"{v:.2f}" for v in dev_us["k2u"]],
        events_us_checked=f"{1e3 * k2c_ms:.2f}",
        events_us_unchecked=f"{1e3 * k2u_ms:.2f}",
        bound_us=f"{1e3 * k2_ms['l0_op'][2]:.2f}",
        max_abs_err=f"{k2c_err:.3e}", card=repr(card))
    # the checked step's one read of the record a step: ms a step of the
    # checked production amg step against the same step unchecked (its
    # kernels checked too), in turns
    T_t = to_t(amg.initial_condition())
    raw_step = type(amg)._step_t
    steps = {"checked": [], "unwrapped": []}
    for label in ("unwrapped", "checked", "checked", "unwrapped"):
        fn = (amg._step_t if label == "checked"
              else lambda: raw_step(amg, T_t))
        steps[label].append(event_ms(
            (lambda: fn(T_t)) if label == "checked" else fn, 5))
    say("time", step="amg_checked", ms_checked=[f"{v:.4f}" for v in
                                                steps["checked"]],
        ms_without_record_read=[f"{v:.4f}" for v in steps["unwrapped"]],
        card=repr(card))
    # (d) a NaN initial condition given by expression, and one index of a
    # K1 and of a K2 operator set out of range by hand after the build: each
    # raises from the checked step (the kernels' error record), not from
    # host code
    try:
        with np.errstate(invalid="ignore"):
            cli.run(CLI_ARGS + NAN_IC + ["--device", "cuda"])
        raise RuntimeError("chip_smoke FAILED: a NaN initial condition "
                           "did not raise")
    except FloatingPointError as e:
        say("sanitizer", nan_ic="FloatingPointError", message=repr(str(e)))
    for which, table, at, bad in (
            ("k1", amg.ops[0].src_cu, 1, amg.ops[0].C * amg.ops[0].U + 7),
            ("k2", amg.agg.levels[0].op.cols_t, 5,
             amg.agg.levels[0].op.n_src + 3)):
        flat = table.view(-1)
        keep = int(flat[at])
        flat[at] = bad
        try:
            amg._step_t(T_t)
            raise RuntimeError(f"chip_smoke FAILED: the {which} index "
                               "fault did not raise")
        except IndexError as e:
            msg = str(e)
            say("sanitizer", index_fault=which, message=repr(msg))
            check("error record" in msg and ("K1" if which == "k1" else "K2")
                  in msg, f"{which}: {msg}")
        finally:
            flat[at] = keep
    amg._step_t(T_t)
    torch.cuda.synchronize()
    del T_t

    # 32. the distributed solver (slice 8) ----------------------------------
    dist_k1_launches, dist_k2_launches, kt1, kt2 = dist_phase(card)

    # 33. the C++ loaders, --profile and solve_system (slice 9) -------------
    native_profile_phase(card)

    # 34. the entry points on the card, the last public names (slice 10) ----
    api_phase(card)

    # 35. float64 on the card: K1 and K2 in double on every path (slice 11)
    f64_entries = f64_phase(card, f32_ref)

    # 36. the port's bench in a process of its own (slice 12) --------------
    bench_phase(card)

    # 37. the distributed bench in processes of their own (slice 13) -------
    t37 = time.perf_counter()
    bench_dist_phase(card)
    say("bench_dist", phase=37, wall_s=f"{time.perf_counter() - t37:.1f}")

    # 38. the knob sweep in a process of its own (slice 14) ----------------
    def solver_parity(path, sv):
        """K1 on sv's fine phase and apply, K2 on every rowop of its SA
        hierarchy, each against its plain version."""
        for case in solver_cases(path, sv):
            k1_parity(*case)
        k2_parity(path, sv.agg.rowops())

    t38 = time.perf_counter()
    tune_amg_phase(card, solver_parity)
    say("tune_amg", phase=38, wall_s=f"{time.perf_counter() - t38:.1f}")

    # bounds: the least bytes over the H100's 3.35 TB/s (a phase's coupling
    # blocks, x0, bp, x and z; the zero-round apply's coupling blocks, x
    # and z; a rowop's tables and vectors); a K1 phase has no library call,
    # the zero-round apply and K2 have cuSPARSE's BSR product
    print(json.dumps({"kernels": [{
        "name": "k1_phase", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/phase.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_stencil.py:176",
        "launches": amg_counts["k1_phase"], "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": k1_bound,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "k2_rowop", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/spmv.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_bsr.py:144",
        "launches": amg_counts["k2_rowop"], "max_abs_err": k2_err,
        "ms": k2_ms["l0_op"][0], "plain_ms": k2_ms["l0_op"][1],
        "bound_ms": k2_ms["l0_op"][2], "bound_by": "bytes",
        "library_ms": k2_ms["l0_op"][3]}, {
        "name": "k1_phase_deep", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/phase.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_stencil.py:608",
        "launches": sweep_deep_launches, "max_abs_err": k3_err,
        "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "k2_rowop_bsr", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/spmv.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_bsr.py:144",
        "launches": m10_counts["k2_rowop"], "max_abs_err": k2_bsr_err,
        "ms": bsr_ms, "plain_ms": bsr_plain_ms, "bound_ms": bsr_bound,
        "bound_by": "bytes", "library_ms": bsr_lib_ms}, {
        "name": "k1_phase_dg", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/phase.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_stencil.py:176",
        "launches": m6_counts["k1_phase"], "max_abs_err": k1_dg_err,
        "ms": k1_dg_ms, "plain_ms": k1_dg_plain_ms, "bound_ms": k1_dg_bound,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "k1_phase_apply", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/phase.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_stencil.py:176",
        "launches": apply_launches, "max_abs_err": apply_err,
        "ms": ka[0][0], "plain_ms": ka[0][1], "bound_ms": ka[0][2],
        "bound_by": "bytes", "library_ms": ka[0][3]}, {
        "name": "k1_phase_checked", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/phase.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_stencil.py:176",
        "launches": main_checked["k1_checked"], "max_abs_err": k1c_err,
        "ms": k1c_ms, "plain_ms": p_ms, "bound_ms": k1_bound,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "k2_rowop_checked", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/spmv.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_bsr.py:144",
        "launches": main_checked["k2_checked"], "max_abs_err": k2c_err,
        "ms": k2c_ms, "plain_ms": k2_ms["l0_op"][1],
        "bound_ms": k2_ms["l0_op"][2], "bound_by": "bytes",
        "library_ms": k2_ms["l0_op"][3]}, {
        "name": "k1_phase_dist", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/phase.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_stencil.py:176",
        "launches": dist_k1_launches, "max_abs_err": kt1["err"],
        "ms": kt1["ms"], "plain_ms": kt1["plain_ms"],
        "bound_ms": kt1["bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "k2_rowop_dist", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/spmv.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_bsr.py:144",
        "launches": dist_k2_launches, "max_abs_err": kt2["err"],
        "ms": kt2["ms"], "plain_ms": kt2["plain_ms"],
        "bound_ms": kt2["bound_ms"], "bound_by": "bytes",
        "library_ms": kt2["library_ms"]}] + f64_entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

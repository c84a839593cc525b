#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (p_a_multigrids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds kernels K1 (csrc/phase.cu) and K2 (csrc/spmv.cu) from this checkout,
holds each against its plain PyTorch version at the main paths' shapes,
drives the mode-9 main paths through the CLI entry at full width (the
geometric V-cycle, the production smoothed-aggregation PCG solve, and the
CLI defaults, whose coarsest level continues into SA levels), runs the
benchmark's geometric and amg V-cycle configurations, the amg PCG solve to
1e-6 and the manufactured-solution PCG gate, times both kernels against
their plain versions, and holds the production CLI run to the same command
on the host CPU (the plain PyTorch path, f32).  Every phase prints its numbers; any failure raises
and the script exits non-zero.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke FAILED: {what}")


def say(tag: str, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


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
    from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t
    from p_a_multigrids_tpu_torch.utils.profiling import (
        amg_solver, bench_solver, cli_solver, event_ms)

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

    # 2. build: one nvcc per kernel source, both started together ----------
    kernels = {"k1_phase_round": K.KERNEL, "k2_rowop": K2.KERNEL}
    with ThreadPoolExecutor(len(kernels)) as pool:
        for fut in [pool.submit(k.function) for k in kernels.values()]:
            fut.result()
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

    x0, b0 = rand(op0), rand(op0)
    x1, b1 = rand(op1), rand(op1)
    cases = [
        ("fine_cheb6_z", op0, x0, op0._bp(b0, True),
         solver._phase_coefs(0, cfg.n_smooth), True, 1e-4),
        ("coarse_cheb8", op1, x1, op1._bp(b1, False),
         solver._phase_coefs(1, cfg.coarse_sweeps), False, 1e-4),
        ("apply_l0", op0, x0, torch.zeros_like(x0), [], True, 1e-5),
        ("apply_l1", op1, x1, torch.zeros_like(x1), [], True, 1e-5),
    ]
    for path, sv in [("amg", amg)] + list(path_sv.items()):
        for li, op in enumerate(o for o in sv.ops if o.C > 1):
            x, b = rand(op), rand(op)
            coefs = sv._phase_coefs(li, sv.cfg.n_smooth)
            cases += [
                (f"{path}_l{li}_cheb{len(coefs)}_z", op, x,
                 op._bp(b, li == 0), coefs, True, 1e-4),
                (f"{path}_apply_l{li}", op, x, torch.zeros_like(x), [], True,
                 1e-5),
            ]
    max_abs_err = 0.0
    for name, op, x, bp, coefs, want_z, rtol in cases:
        n0 = K.KERNEL.launches
        xk, zk = K.phase(op, x, bp, coefs, want_z)
        torch.cuda.synchronize()
        launched = K.KERNEL.launches - n0
        check(launched == len(coefs) + int(want_z),
              f"{name}: {launched} launches for {len(coefs)} rounds"
              f" + z={want_z}")
        xr, zr = K.phase_reference(op, x, bp, coefs, want_z)
        pairs = [("x", xk, xr)] + ([("z", zk, zr)] if want_z else [])
        for which, got, ref in pairs:
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            max_abs_err = max(max_abs_err, err)
            say("parity", case=name, out=which, C=op.C, U=op.U,
                rounds=len(coefs) + int(want_z), max_abs_err=f"{err:.3e}",
                max_ref=f"{scale:.3e}", rel=f"{err / scale:.3e}",
                tol=rtol)
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
            check(err <= rtol * scale, f"{name} {which}: |K1 - plain| "
                  f"{err:.3e} > {rtol} * {scale:.3e}")

    # 3b. K2 parity: every block-row operator of each SA hierarchy that a
    # main path runs (the stand-in's production hierarchy, the production
    # CLI's and the CLI defaults') -------------------------------------------
    rowops = amg.agg.rowops()
    k2_err = 0.0
    for path, h in (("amg", amg.agg), ("amg_cli", path_sv["amg_cli"].agg),
                    ("defaults", path_sv["defaults"].agg)):
        say("rowops", config=path, shapes={
            k: (op.n_out, op.D, op.n_src) for k, op in h.rowops().items()})
        for name, op in h.rowops().items():
            x = torch.as_tensor(
                rng.normal(size=(3, op.n_src)).astype(np.float32), device=dev)
            n0 = K2.KERNEL.launches
            got = op(x)
            torch.cuda.synchronize()
            check(K2.KERNEL.launches - n0 == 1,
                  f"{path} {name}: {K2.KERNEL.launches - n0} K2 launches for "
                  "one apply")
            ref = K2.rowop_reference(op.cols_t, op.vals_t, x)
            # two summation orders of 3*D f32 products each lie within
            # 3*D*2^-24 of the exact sum, relative to the sum of |products|
            absum = float(K2.rowop_reference(op.cols_t, op.vals_t.abs(),
                                             x.abs()).max())
            tol = 2 * 3 * op.D * 2.0 ** -24 * absum
            err = float((got - ref).abs().max())
            k2_err = max(k2_err, err)
            say("parity", kernel="k2", config=path, case=name, N=op.n_out,
                D=op.D, S=op.n_src, max_abs_err=f"{err:.3e}",
                max_ref=f"{float(ref.abs().max()):.3e}", tol=f"{tol:.3e}")
            check(bool(torch.isfinite(got).all()),
                  f"{path} {name}: non-finite")
            check(err <= tol,
                  f"{path} {name}: |K2 - plain| {err:.3e} > {tol:.3e}")
    del path_sv

    # 4. main paths through the CLI entry; each path's counts are set to 0
    # just before it and read just after it ----------------------------------
    def drive(args):
        K.KERNEL.launches = K2.KERNEL.launches = 0
        out = cli.main(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        return out, {"k1_phase_round": K.KERNEL.launches,
                     "k2_rowop": K2.KERNEL.launches}

    out, counts = drive(CLI_ARGS)
    main_launches = counts["k1_phase_round"]
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
    say("main", path="amg_pcg", launches=amg_counts,
        residual_history=amg_out["residual_history"],
        jax_cpu=AMG_CLI["residual_history"],
        krylov_iterations=amg_out["krylov_iterations"],
        jax_krylov_iterations=AMG_CLI["krylov_iterations"],
        L1_error=amg_out["L1_error"], jax_L1_error=AMG_CLI["L1_error"],
        wall_s=amg_out["wall_s"])
    check(amg_counts["k1_phase_round"] > 0 and amg_counts["k2_rowop"] > 0,
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
    check(dflt_counts["k1_phase_round"] > 0 and dflt_counts["k2_rowop"] > 0,
          f"the defaults path did not launch both kernels: {dflt_counts}")
    for got, want in zip(dflt["residual_history"], DEFAULT_HISTORY):
        check(abs(got - want) <= 0.01 * want,
              f"defaults residual {got:.6g} not within 1% of {want}")

    # 5. bench-geometric configuration at 393,216 DOF ------------------------
    T0_t = to_t(solver.initial_condition())
    b_t = solver._rhs_t(T0_t)
    x_t = T0_t
    bench = []
    for _ in range(10):
        x_t = solver._vcycle_t(0, x_t, b_t)
        r = solver.residual(0, from_t(x_t), from_t(b_t), True)
        bench.append(float(r.abs().max()))
    say("bench", residual_history=[f"{v:.4e}" for v in bench])
    say("bench", jax_cpu=BENCH_HISTORY)
    for got, want in zip(bench, BENCH_HISTORY):
        check(np.isfinite(got) and abs(got - want) <= 0.02 * want,
              f"bench residual {got:.4e} not within 2% of {want:.4e}")
    state = {"x": T0_t}

    def cycle():
        state["x"] = solver._vcycle_t(0, state["x"], b_t)

    for _ in range(3):
        cycle()
    vc_ms = event_ms(cycle, 20)
    say("bench", ms_per_vcycle=f"{vc_ms:.4f}", card=repr(card))

    # 5b. production amg V-cycle and PCG to 1e-6 at 393,216 DOF -------------
    T0_t = to_t(amg.initial_condition())
    b_t = amg._rhs_t(T0_t)
    x_t = T0_t
    amg_hist = []
    for _ in range(10):
        x_t = amg._vcycle_t(0, x_t, b_t)
        r = amg.residual(0, from_t(x_t), from_t(b_t), True)
        amg_hist.append(float(r.abs().max()))
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
    state = {"x": T0_t}

    def amg_cycle():
        state["x"] = amg._vcycle_t(0, state["x"], b_t)

    for _ in range(3):
        amg_cycle()
    amg_ms = event_ms(amg_cycle, 20)
    say("amg", ms_per_vcycle=f"{amg_ms:.4f}", card=repr(card))

    op_a = amg.ops[0]
    b_lin = b_t - op_a.apply(torch.zeros_like(b_t), True)

    def pcg_solve():
        return krylov.pcg(
            lambda v: amg._apply_t(0, v, False), b_lin,
            torch.zeros_like(b_lin),
            precond=lambda r: amg._vcycle_t(0, torch.zeros_like(r), r,
                                            hom=True),
            tol=1e-6, maxiter=40)

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
    coefs = solver._phase_coefs(0, cfg.n_smooth)
    bp0 = op0._bp(b0, True)
    run_k = lambda: K.phase(op0, x0, bp0, coefs, True)
    run_p = lambda: K.phase_reference(op0, x0, bp0, coefs, True)
    for fn in (run_k, run_p):
        for _ in range(3):
            fn()
    n_before = K.KERNEL.launches
    times = {"plain": [], "kernel": []}
    for label, fn in (("plain", run_p), ("kernel", run_k),
                      ("kernel", run_k), ("plain", run_p)):
        times[label].append(event_ms(fn, 20))
    k_ms = sum(times["kernel"]) / 2
    p_ms = sum(times["plain"]) / 2
    check(K.KERNEL.launches - n_before == 40 * (len(coefs) + 1),
          "timed kernel phases did not launch K1")
    say("time", phase="fine_cheb6_z", C=op0.C, U=op0.U,
        k1_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
        k1_runs=[f"{v:.4f}" for v in times["kernel"]],
        plain_runs=[f"{v:.4f}" for v in times["plain"]], card=repr(card))

    # 8. K2 against the plain version: the level-0 operator and the fine
    # tentative restriction ---------------------------------------------------
    k2_ms = {}
    for name in ("l0_op", "fine_tent_r"):
        op = rowops[name]
        x = torch.as_tensor(rng.normal(size=(3, op.n_src)).astype(np.float32),
                            device=dev)
        run_k = lambda: op(x)
        run_p = lambda: K2.rowop_reference(op.cols_t, op.vals_t, x)
        for fn in (run_k, run_p):
            for _ in range(3):
                fn()
        n_before = K2.KERNEL.launches
        times = {"plain": [], "kernel": []}
        for label, fn in (("plain", run_p), ("kernel", run_k),
                          ("kernel", run_k), ("plain", run_p)):
            times[label].append(event_ms(fn, 50))
        check(K2.KERNEL.launches - n_before == 100,
              f"timed {name} applies did not launch K2")
        k2_ms[name] = (sum(times["kernel"]) / 2, sum(times["plain"]) / 2)
        say("time", rowop=name, N=op.n_out, D=op.D, S=op.n_src,
            k2_ms=f"{k2_ms[name][0]:.5f}", plain_ms=f"{k2_ms[name][1]:.5f}",
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

    print(json.dumps({"kernels": [{
        "name": "k1_phase_round", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/phase.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_stencil.py:176",
        "launches": amg_counts["k1_phase_round"], "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms}, {
        "name": "k2_rowop", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/spmv.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_bsr.py:144",
        "launches": amg_counts["k2_rowop"], "max_abs_err": k2_err,
        "ms": k2_ms["l0_op"][0], "plain_ms": k2_ms["l0_op"][1]}]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (p_a_multigrids_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds kernel K1 (csrc/phase.cu) from this checkout, holds it against its
plain PyTorch version at the main path's shapes, drives the mode-9 main path
through the CLI entry at full width, runs the benchmark's geometric V-cycle
configuration and the manufactured-solution PCG gate, and times K1 against
the plain version.  Every phase prints its numbers; any failure raises and
the script exits non-zero.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# JAX package on CPU, f32 (python -m p_a_multigrids_tpu --mode 9 --cpu
# --rows 24 --cols 24 --n-split 3 --levels 4 --ntime 2)
CLI_HISTORY = [0.28839, 0.077034]
# JAX package on CPU, f32: the bench-geometric configuration below,
# solver.residual(0, x, b, True) after each of 10 V-cycles from T0
BENCH_HISTORY = [1.3474e-01, 3.3982e-02, 2.3502e-02, 1.7760e-02, 1.4149e-02,
                 1.1972e-02, 1.0330e-02, 9.0518e-03, 8.0156e-03, 7.1683e-03]
CLI_ARGS = ["--mode", "9", "--rows", "24", "--cols", "24", "--n-split", "3",
            "--levels", "4", "--ntime", "2", "--device", "cuda"]
GATE_ARGS = ["--mode", "9", "--rows", "24", "--cols", "24", "--n-split",
             "2", "--levels", "3", "--dt", "1e8", "--krylov", "--krylov-tol",
             "1e-6", "--ntime", "1", "--device", "cuda"]


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
    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops.fused import from_t, to_t
    from p_a_multigrids_tpu_torch.utils.profiling import (
        bench_solver, cli_solver, event_ms)

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

    # 2. build ---------------------------------------------------------------
    K.KERNEL.function()
    info = K.KERNEL.build_info
    say("build", seconds=f"{info['seconds']:.2f}", cached=info["cached"],
        path=info["path"])
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("[build] ptxas:", line.strip(), flush=True)

    # 3. kernel parity on the stand-in mesh and the CLI configuration -------
    t0 = time.time()
    solver = bench_solver(dev)
    cfg = solver.cfg
    op0, op1 = solver.ops
    say("setup", config="bench", macros=op0.U,
        dof=3 * op0.C * op0.U, levels=[(op.C, op.U) for op in solver.ops],
        seconds=f"{time.time() - t0:.1f}")
    # the levels K1 runs on in phase 4: the CLI's mesh and configuration
    # (C = 64, 16, 4 at U = 1152; the C = 1 level is the dense solve)
    t0 = time.time()
    cli_sv = cli_solver(dev)
    cli_ops = [op for op in cli_sv.ops if op.C > 1]
    say("setup", config="cli", macros=cli_ops[0].U,
        dof=3 * cli_ops[0].C * cli_ops[0].U,
        levels=[(op.C, op.U, op.nb) for op in cli_ops],
        seconds=f"{time.time() - t0:.1f}")
    check([op.C for op in cli_ops] == [64, 16, 4],
          f"CLI levels {[op.C for op in cli_ops]}, expected C = 64, 16, 4")
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
    for li, op in enumerate(cli_ops):
        x, b = rand(op), rand(op)
        cases += [
            (f"cli_l{li}_cheb6_z", op, x, op._bp(b, li == 0),
             cli_sv._phase_coefs(li, cli_sv.cfg.n_smooth), True, 1e-4),
            (f"cli_apply_l{li}", op, x, torch.zeros_like(x), [], True, 1e-5),
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

    # 4. main path through the CLI entry -------------------------------------
    K.KERNEL.launches = 0
    out = cli.main(CLI_ARGS)
    torch.cuda.synchronize()
    main_launches = K.KERNEL.launches
    hist = out["residual_history"]
    say("main", launches=main_launches, residual_history=hist,
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

    # 6. manufactured gate with PCG -----------------------------------------
    gate = cli.main(GATE_ARGS)
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

    print(json.dumps({"kernels": [{
        "name": "k1_phase_round", "route": "cuda",
        "source": "p_a_multigrids_tpu_torch/csrc/phase.cu",
        "replaces": "p_a_multigrids_tpu/ops/pallas_stencil.py:176",
        "launches": main_launches, "max_abs_err": max_abs_err,
        "ms": k_ms, "plain_ms": p_ms}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

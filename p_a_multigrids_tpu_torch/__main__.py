"""CLI entry point of the port (modes 1-10).

    python -m p_a_multigrids_tpu_torch --mode 9 --rows 24 --cols 24 \\
        --n-split 3 --levels 4 --ntime 2 --device cuda
    python -m p_a_multigrids_tpu_torch --mode 9 --rows 128 --cols 32 \\
        --solver jacobi --omega 0.8 --no-surface-terms \\
        --restrictor corner_average --n-multigrid 6 --device cuda
    python -m p_a_multigrids_tpu_torch --mode 9 --mesh macro.msh \\
        --n-split 5 --levels 6 --cycle-type w --dt 1e8 --device cuda
    python -m p_a_multigrids_tpu_torch --mode 9 --mesh domain.geo \\
        --ic 0 --bc "sin(x+y)" --source "2*sin(x+y)" \\
        --analytical "sin(x+y)" --vtu out.vtu --vtk-interval 1 \\
        --checkpoint run.npz --checkpoint-every 1 --debug
    python -m p_a_multigrids_tpu_torch --mode 1 --rows 200 --cols 1024

Modes mirror the JAX package's CLI: 1 rectangular DG advection (the moving
box), 2-6 the triangular-mesh transport solvers (2/4 explicit, 3/5
implicit, 6 advection-diffusion; split depth 0), 7 semi explicit (theta =
0), 8 semi direct (dense inverse), 9 semi multigrid (V-cycles or, with
--krylov, PCG / BiCGStab under --u; any --solver; at n_split >= 8 the
non-stencil operator), 10 semi assembled (block-Jacobi sweeps over the BSR
operator).  The macro mesh is a gmsh 2.x ASCII ``--mesh`` file, a gmsh
``.geo`` geometry (``mesh.geo.mesh_geo``), else the generated ``--rows`` x
``--cols`` unit square.  ``--ic``, ``--bc``, ``--source`` and
``--analytical`` are expressions of x and y (``utils.expressions``); any of
the first three turns the built-in manufactured sin(x+y) problem off.
``--vtu`` writes the final Tracer field, ``--vtk-interval N`` the
Tracer / error / analytical series of modes 7, 9 and 10 every N steps,
``--checkpoint`` saves modes 7, 9 and 10 every ``--checkpoint-every``
steps and resumes from the file when it exists, and ``--debug`` runs the
checked step (``utils.debugging``: checked builds of kernels K1 and K2 on
the card).  Prints one JSON line with the JAX package's keys for the mode
(mode 1: mode, ntime, dt, t_range and with --curves the files; modes 2-6:
mode, elements, wall_s; 7, 9, 10: also residual_history, children,
L1_error, residual; 8: the same without residual_history; vtu,
vtu_series and resumed_from_step with their flags), plus
krylov_iterations with --krylov in modes 7 and 9.  ``--cpu`` is
``--device cpu``.

``--devices N`` runs mode 9 on N ranks (``parallel.comm.launch``: one
process a rank over torch.distributed, on --device; CUDA ranks sharing one
card talk through gloo) through ``parallel.stencil_solver.
DistributedStencilSolver``, with ``--dist-ghost-frac`` its ghost-depth cap
and ``--checkpoint`` / ``--checkpoint-every`` as above; rank 0's line has
the JAX CLI's keys of that path (mode, devices, elements, children,
L1_error, wall_s, resumed_from_step with a resumed checkpoint, vtu with
--vtu).

``--profile DIR`` traces the run with torch.profiler (the CPU and the CUDA
devices) into the Chrome trace ``DIR/trace.json`` (``utils.profiling.
trace``), closed also when the solve raises; under ``--devices N`` each
rank writes ``DIR/trace_rank<r>.json``.  The JSON line then carries
``profile_dir`` and, on one device, ``counters``: ``utils.tracing.
snapshot()`` of the run (its counters from the start of ``run``: the
time steps, the Krylov loops' host syncs, the kernel builds and loads;
the seconds of each set-up stage; each span's calls and host and self
microseconds in the trace, by name: ``pamg.step``, ``pamg.vcycle.l<i>``,
``pamg.sa.l<k>``, ``pamg.k1``, ...; and the process's K1 and K2
launches).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time


def _parser():
    ap = argparse.ArgumentParser(prog="p_a_multigrids_tpu_torch")
    ap.add_argument("--mode", type=int, default=9)
    ap.add_argument("--rows", type=int, default=20)
    ap.add_argument("--cols", type=int, default=20)
    ap.add_argument("--n-split", type=int, default=2)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--ntime", type=int, default=2)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--theta", type=float, default=1.0)
    ap.add_argument("--k", type=float, default=1.0)
    ap.add_argument("--u", type=float, nargs=2, default=(0.0, 0.0))
    ap.add_argument("--solver", type=str, default=None,
                    choices=["jacobi", "richardson", "gauss_seidel",
                             "block_jacobi", "chebyshev", "direct"])
    ap.add_argument("--krylov", action="store_true",
                    help="V-cycle-preconditioned PCG per step (BiCGStab "
                         "with advection, --u)")
    ap.add_argument("--krylov-tol", type=float, default=1e-8)
    ap.add_argument("--amg", action="store_true",
                    help="strength-filtered smoothed-aggregation correction "
                         "of the finest level (kernel K2 on the GPU)")
    ap.add_argument("--agg-strength", type=float, default=0.4)
    ap.add_argument("--cheb-degree", type=int, default=6)
    ap.add_argument("--cheb-lower", type=float, default=0.1)
    ap.add_argument("--coarse-cheb-degree", type=int, default=None)
    ap.add_argument("--coarse-cheb-lower", type=float, default=None)
    ap.add_argument("--coarse-pack", type=int, default=1,
                    help="accepted for parity; coarse levels run unpacked "
                         "(a pure relabeling)")
    ap.add_argument("--cycle-type", type=str, default="v",
                    choices=["v", "w"])
    ap.add_argument("--restrictor", type=str, default="linear",
                    choices=["linear", "corner_average"])
    ap.add_argument("--no-surface-terms", action="store_true")
    ap.add_argument("--omega", type=float, default=0.8)
    ap.add_argument("--n-smooth", type=int, default=4)
    ap.add_argument("--n-multigrid", type=int, default=2)
    ap.add_argument("--f64", action="store_true",
                    help="float64 on any device (kernels K1 and K2 take "
                         "float32 and float64)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device: cuda runs kernel K1, cpu its plain "
                         "PyTorch version")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu (the JAX CLI's flag)")
    ap.add_argument("--curves", type=str, default=None, metavar="PREFIX",
                    help="mode 1: write the curve files PREFIX and "
                         "PREFIX_analytical (x value per DG node)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="gmsh 2.x ASCII macro mesh (.msh) or gmsh geometry "
                         "(.geo); default: the generated --rows x --cols "
                         "unit square")
    ap.add_argument("--vtu", type=str, default=None,
                    help="write the final Tracer field to this .vtu")
    ap.add_argument("--vtk-interval", type=int, default=0, metavar="N",
                    help="modes 7, 9, 10: write Tracer/error/analytical "
                         "VTUs every N steps and at the end, as "
                         "<--vtu base>_NNNN.vtu")
    ap.add_argument("--checkpoint", type=str, default=None, metavar="NPZ",
                    help="modes 7, 9, 10: checkpoint the run to this .npz "
                         "and resume from it when it exists")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    for flag, what in (("--ic", "initial condition"),
                       ("--bc", "Dirichlet boundary value"),
                       ("--source", "volume source"),
                       ("--analytical", "exact solution (error field)")):
        ap.add_argument(flag, type=str, default=None, metavar="EXPR",
                        help=f"{what} as an expression of x, y")
    ap.add_argument("--debug", action="store_true",
                    help="modes 7, 9, 10: the checked step (index tables "
                         "range-checked at setup, the state asserted "
                         "finite, checked builds of kernels K1 and K2 on "
                         "the card; one synchronisation a step)")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="trace the run with torch.profiler into the "
                         "Chrome trace DIR/trace.json (one file a rank "
                         "with --devices)")
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="mode 9: run the distributed stencil solver on N "
                         "ranks")
    ap.add_argument("--dist-ghost-frac", type=float, default=0.25,
                    help="with --devices: ghost rows of a smoothing phase "
                         "at most this fraction of a rank's macros (else "
                         "its rounds run in chunks)")
    return ap


def _parse(argv):
    """Parse and check the arguments; returns (args, device)."""
    args = _parser().parse_args(argv)
    if not 1 <= args.mode <= 10:
        raise SystemExit(f"unknown mode {args.mode}")

    import torch

    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(use --device cpu for the plain PyTorch path)")
    if args.devices and args.debug:
        raise SystemExit("--debug runs on one device: leave out --devices")
    return args, device


def _mesh(args):
    from .mesh import structured, topology
    if args.mesh and args.mesh.endswith(".geo"):
        from .mesh import geo
        return geo.mesh_geo(args.mesh)
    if args.mesh:
        return topology.from_msh(args.mesh)
    return structured.tri_mesh(args.rows, args.cols, 1.0 / args.rows,
                               1.0 / args.cols)


def _transport_cfg(args):
    """The TransportConfig of modes 2-6 (3, 5, 6 implicit; 6 with
    diffusion)."""
    from .config import TransportConfig

    return TransportConfig(
        ntime=args.ntime, dt=args.dt, u=tuple(args.u), k=args.k,
        diffusion=args.mode == 6 or args.k != 0.0,
        implicit=args.mode in (3, 5, 6), theta=args.theta,
        dtype="float64" if args.f64 else "float32")


def _problem_fns(args):
    """--ic/--bc/--source/--analytical strings -> ProblemFns."""
    from .config import ProblemFns
    from .utils.expressions import Expression

    def comp(text):
        return Expression(text) if text else None
    return ProblemFns(ic=comp(args.ic), bc=comp(args.bc),
                      source=comp(args.source),
                      analytical=comp(args.analytical))


def _semi_cfg(args):
    """The SemiConfig of modes 7-10 (mode 7: the theta = 0 explicit step,
    one exact block-Jacobi round).  The manufactured sin(x+y) problem is on
    unless --ic, --bc or --source is given, as in the JAX CLI; the error is
    then measured against --analytical, or against zero without it."""
    from .config import Physics, SemiConfig, Solver

    cfg = SemiConfig(
        n_split=args.n_split, multi_levels=args.levels,
        ntime=args.ntime, dt=args.dt or 1.25e-5, theta=args.theta,
        n_multigrid=args.n_multigrid, n_smooth=args.n_smooth,
        omega=args.omega, cheb_degree=args.cheb_degree,
        cheb_lower=args.cheb_lower, cycle_type=args.cycle_type,
        restrictor=args.restrictor, krylov=args.krylov,
        krylov_tol=args.krylov_tol, amg=args.amg,
        agg_strength=args.agg_strength,
        coarse_cheb_degree=args.coarse_cheb_degree,
        coarse_cheb_lower=args.coarse_cheb_lower,
        coarse_pack=args.coarse_pack,
        dist_ghost_max_frac=args.dist_ghost_frac,
        physics=Physics(k=args.k, u=tuple(args.u),
                        advection=any(args.u),
                        surface_terms=not args.no_surface_terms),
        fns=_problem_fns(args), manufactured=all(
            v is None for v in (args.ic, args.bc, args.source)),
        dtype="float64" if args.f64 else "float32", debug=args.debug)
    if args.solver:
        cfg = dataclasses.replace(cfg, solver=Solver(args.solver))
    if args.mode == 7:
        cfg = dataclasses.replace(
            cfg, theta=0.0, multi_levels=1, n_multigrid=1, n_smooth=1,
            omega=1.0, solver=Solver.BLOCK_JACOBI)
    return cfg


def _stepping_solver(args, device):
    """(mesh, solver) of a time-stepping mode: 7 and 9 a ``SemiSolver``,
    10 an ``AssembledSemiSolver``."""
    from .models import semi, semi_assembled

    if args.mode not in (7, 9, 10):
        raise SystemExit(f"mode {args.mode} builds no stepping solver")
    mesh = _mesh(args)
    cls = (semi_assembled.AssembledSemiSolver if args.mode == 10
           else semi.SemiSolver)
    return mesh, cls(semi.build_problem(mesh, _semi_cfg(args)), device)


def setup(argv=None):
    """Parse the CLI's arguments and build its mesh and the solver of a
    time-stepping mode (7, 9, 10) as ``main`` runs them: returns (args,
    mesh, solver)."""
    args, device = _parse(argv)
    return (args,) + _stepping_solver(args, device)


def _rect_cfg(args):
    """The RectConfig of mode 1 (the moving box on the --rows x --cols quad
    mesh)."""
    from .config import RectConfig

    return RectConfig(no_ele_row=args.rows, no_ele_col=args.cols,
                      u=tuple(args.u) if any(args.u)
                      else (2 * 0.01428571, 0.0),
                      dtype="float64" if args.f64 else "float32")


def _rect(args, device, out):
    """Mode 1: the moving box on the --rows x --cols quad mesh; fills out
    with ntime, dt, t_range (and the curve files with --curves) and
    returns (T (E, 4), the problem)."""
    import numpy as np

    from .models import transport_rect

    problem, T, dt, ntime = transport_rect.solve(_rect_cfg(args), device)
    vals = T.cpu().numpy()
    out.update(ntime=ntime, dt=dt,
               t_range=[float(vals.min()), float(vals.max())])
    if args.curves:
        from .io import curves

        curves.write_curve(args.curves, problem.x_all, vals, two_d=False)
        ana = transport_rect.analytical_comparison(problem, dt, ntime)
        curves.write_curve(f"{args.curves}_analytical", problem.x_all,
                           np.asarray(ana), two_d=False)
        out["curves"] = [args.curves, f"{args.curves}_analytical"]
    return T, problem


def _time_loop(args, solver, out):
    """Modes 7, 9 and 10: cfg.ntime steps from the initial condition, or
    from the --checkpoint file when it exists, with the --vtk-interval
    series and the --checkpoint saves (``checkpoint.run_with_checkpoints``);
    fills out's residual_history (and resumed_from_step, vtu_series) and
    returns the final state (U, C, 3)."""
    import os

    import numpy as np

    from . import convert
    from .io import checkpoint, vtu

    cfg = solver.cfg
    coords = None

    def write_series(T, step):
        """Tracer + error + analytical point fields, the get_vtk_files
        set, every --vtk-interval steps (one copy of T to the host)."""
        nonlocal coords
        if coords is None:
            coords = vtu.semi_coords(solver.p.grid.macro.X, cfg.n_split)
        base = (args.vtu or "out.vtu")[: -4]
        T_np = convert.state_to_numpy(T)
        fields = {"Tracer": T_np.reshape(-1, 3),
                  "error": np.abs(T_np - solver.p.analytical).reshape(-1, 3),
                  "analytical": solver.p.analytical.reshape(-1, 3)}
        path = f"{base}_{step:04d}.vtu"
        vtu.write_vtu(path, coords, fields, cell_type=5)
        out.setdefault("vtu_series", []).append(path)

    T = solver.initial_condition()
    start = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        T_np, start, _, _ = checkpoint.load(args.checkpoint)
        T = convert.state_from_numpy(solver, T_np)
        out["resumed_from_step"] = start
    hist = []

    def observe(k, S, st):
        """After k steps: the residual of each step taken here, and the
        series every --vtk-interval steps and at the end."""
        if k > start:
            hist.append(float(st.convergence(S)))
        if args.vtk_interval and (k % args.vtk_interval == 0
                                  or k == cfg.ntime):
            write_series(st.from_state(S), k)

    T = checkpoint.run_with_checkpoints(
        solver, T, cfg.ntime, args.checkpoint, args.checkpoint_every, start,
        observe)
    out["residual_history"] = hist
    return T


def _vtu_final(args, out, T, solver):
    """--vtu: the final Tracer field with each mode's element coordinates
    (mode 1: quads, cell type 9; else triangles, 5)."""
    from .io import vtu
    from .mesh import splitting

    if args.mode == 1:
        coords = solver.x_all
    elif args.mode <= 6:
        coords = splitting.child_coords(solver.p.grid.macro.X,
                                        0).reshape(-1, 2, 3)
    else:
        coords = vtu.semi_coords(solver.p.grid.macro.X, args.n_split)
    vals = T.detach().cpu().numpy()
    if args.mode != 1:
        vals = vals.reshape(-1, 3)
    vtu.write_vtu(args.vtu, coords, {"Tracer": vals},
                  cell_type=9 if args.mode == 1 else 5)
    out["vtu"] = args.vtu


def run(argv=None):
    """Run the CLI without printing: returns (the JSON dict, the final
    state T (U, C, 3) on the run's device, the solver that ran the last
    steps); in mode 1, T (E, 4) and the ``RectProblem``; with --devices,
    (the JSON dict, None, None): the state stays in the ranks."""
    from .utils import tracing

    t0 = time.time()
    args, device = _parse(argv)
    out = {"mode": args.mode}
    if args.profile:
        out["profile_dir"] = args.profile
        tracing.reset()
    if args.devices and args.mode == 9:
        import os

        from .parallel import comm, programs

        argv = sys.argv[1:] if argv is None else list(argv)
        out.update(comm.launch(
            programs.cli_rank, args.devices, device, args=(argv,),
            threads=max(1, (os.cpu_count() or 1) // args.devices))[0])
        out["wall_s"] = round(time.time() - t0, 3)
        return out, None, None
    with _profiled(args.profile):
        T, solver = _dispatch(args, device, out)
    if args.profile:
        out["counters"] = tracing.snapshot()
    out["wall_s"] = round(time.time() - t0, 3)
    if args.vtu:
        _vtu_final(args, out, T, solver)
    return out, T, solver


def _profiled(logdir: str | None, rank: int | None = None):
    """The --profile trace of a block (``utils.profiling.trace``), or no
    trace without the flag."""
    if not logdir:
        return contextlib.nullcontext()
    from .utils import profiling

    return profiling.trace(logdir, rank)


def _dispatch(args, device, out):
    """The run of one mode on one device: fills out and returns (the final
    state, the solver or problem), its device work finished."""
    import torch

    if args.mode == 1:
        T, solver = _rect(args, device, out)
    elif args.mode <= 6:
        from .models import transport

        mesh = _mesh(args)
        solver, T = transport.solve(mesh, _transport_cfg(args),
                                    device=device)
        out["elements"] = mesh.num_elements
    else:
        if args.mode == 8:
            from .models import semi_assembled

            mesh = _mesh(args)
            solver, T = semi_assembled.direct_solve(mesh, _semi_cfg(args),
                                                    device)
        else:
            mesh, solver = _stepping_solver(args, device)
            T = _time_loop(args, solver, out)
        out.update(elements=mesh.num_elements, children=4 ** args.n_split,
                   L1_error=float(solver.error(T).mean()),
                   residual=float(solver.convergence(T)))
        if solver.cfg.krylov and args.mode in (7, 9):
            out["krylov_iterations"] = list(solver.krylov_iters)
        if solver.sanitizer is not None:
            # the error and residual above ran checked kernels too
            solver.sanitizer.raise_on_fault()
    if T.device.type == "cuda":
        torch.cuda.synchronize(T.device)
    return T, solver


def main(argv=None) -> dict:
    """Run the CLI; prints the JSON line and returns it as a dict."""
    out = run(argv)[0]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

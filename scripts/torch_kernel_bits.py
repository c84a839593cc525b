"""Kernels K1 and K2 of one checkout against another's, bit for bit, on the
GPU.

    PYTHONPATH=OLD python scripts/torch_kernel_bits.py --save old.npz
    PYTHONPATH=.   python scripts/torch_kernel_bits.py --save new.npz \
        --compare old.npz

Each run builds the kernels of the ``p_a_multigrids_tpu_torch`` on its
PYTHONPATH, runs a fixed set of seeded float32 cases through them and saves
the outputs; ``--compare`` then requires every output of this run to equal
the other run's bit for bit, and exits 1 naming the first that differs.
The cases: K1 in each of its float32 tiers (small, resident, forced
stream) on a Chebyshev phase with z and on the zero-round apply, at C = 16
(the bench-geometric fine level, 8,192 macros), C = 1 and C = 1024; K2 in
both variants on square and rectangular operators.  A change that only
adds a float64 instantiation must leave these bits as they were.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def cases(dev):
    """name -> output tensor of each case, computed on dev."""
    from p_a_multigrids_tpu_torch.config import SemiConfig
    from p_a_multigrids_tpu_torch.mesh import structured
    from p_a_multigrids_tpu_torch.models import semi
    from p_a_multigrids_tpu_torch.ops import phase as K
    from p_a_multigrids_tpu_torch.ops import smoothers, spmv, stencil

    out = {}
    for n_split, mesh, tiers in (
            (2, (128, 32, 3 / 128, 1 / 128), (None, "stream")),
            (2, (6, 5, 0.2, 0.25), (None, "resident")),
            (0, (6, 5, 0.2, 0.25), (None, "stream")),
            (5, (6, 5, 0.2, 0.25), (None, "stream"))):
        cfg = SemiConfig(n_split=n_split, multi_levels=1, dt=0.05)
        L = semi.build_problem(structured.tri_mesh(*mesh), cfg).levels[0]
        data = stencil.build_stencil(L, cfg.physics, cfg.dt, cfg.theta)
        op = stencil.StencilOperator(data, torch.float32, dev)
        cheb = [1.0 / r for r in smoothers.chebyshev_roots(
            stencil.lam_max_estimate(data), 6, 0.1)]
        rng = np.random.default_rng(n_split + op.U)
        x, b = (torch.tensor(rng.normal(size=(3, op.C, op.U)),
                             dtype=torch.float32, device=dev)
                for _ in range(2))
        for tier in tiers:
            name = f"k1_C{op.C}_U{op.U}_{tier or K.KERNEL.plan(op).tier}"
            xk, zk = K.phase_on_tier(op, x, op._bp(b, True), cheb, True,
                                     tier)
            out[f"{name}_x"], out[f"{name}_z"] = xk, zk
            out[f"{name}_apply"] = K.phase_on_tier(
                op, x, torch.zeros_like(x), [], True, tier)[1]
    for n_out, n_src, D in ((1000, 1000, 13), (300, 1000, 25),
                            (1000, 300, 3), (513, 2047, 141)):
        rng = np.random.default_rng(D)
        cols = rng.integers(0, n_src, size=(n_out, D))
        vals = rng.normal(size=(n_out, D, 3, 3))
        x = torch.tensor(rng.normal(size=(3, n_src)), dtype=torch.float32,
                         device=dev)
        for variant in ("thread", "lanes"):
            op = spmv.RowOp(cols, vals, n_src, torch.float32, dev, variant)
            out[f"k2_{n_out}x{D}_{variant}"] = op(x)
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", required=True, help="write the outputs here")
    ap.add_argument("--compare", help="outputs of another checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_bits: needs a CUDA device")
    import p_a_multigrids_tpu_torch
    got = cases(torch.device("cuda"))
    np.savez(args.save, **got)
    print(f"[bits] package={p_a_multigrids_tpu_torch.__file__} "
          f"cases={len(got)} saved={args.save}", flush=True)
    if args.compare:
        with np.load(args.compare) as old:
            missing = sorted(set(got) ^ set(old.files))
            if missing:
                raise SystemExit(f"torch_kernel_bits: cases differ: "
                                 f"{missing}")
            for name in sorted(got):
                same = np.array_equal(got[name].view(np.uint32),
                                      old[name].view(np.uint32))
                print(f"[bits] case={name} shape={got[name].shape} "
                      f"bits_equal={same}", flush=True)
                if not same:
                    sys.exit(1)
        print(f"[bits] all {len(got)} cases equal bit for bit", flush=True)


if __name__ == "__main__":
    main()

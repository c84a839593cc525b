"""One relaxation phase of a level's block stencil: kernel K1.

A phase runs ``len(coefs)`` Jacobi-type rounds x <- x + coef_r * z(x), with
z(x) = D^-1 (b - A x) = bp - x - D^-1 (A - D) x, each round reading only
the previous round's state, plus (``want_z``) a trailing coef-0 round whose
z is returned.  With no coefs and ``want_z`` the single round gives
z = bp - D^-1 A x, so with bp = 0, A x = -D z (``SemiSolver._apply_t``).

On a CUDA tensor every round is one launch of the hand-written kernel in
``csrc/phase.cu``, the port of the TPU kernels ``PhaseOperator._kernel``
(C <= 64 children per macro) and ``PhaseOperatorResident._kernel`` (C > 64:
n_split 4 and 5) of ``p_a_multigrids_tpu/ops/pallas_stencil.py``: one
kernel gathers children through an index table at any C.  On a CPU tensor
the plain PyTorch version ``phase_reference`` runs instead; it is also what
the tests and ``chip_smoke.py`` hold the kernel against.  There is no
fallback: on a CUDA tensor the kernel builds and launches, or this module
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .stencil import StencilOperator


# the TPU kernel PhaseOperatorResident took the levels with more children
DEEP_C = 64


class PhaseKernel:
    """ctypes binding of ``k1_phase_round`` with its launch counts.

    ``launches`` grows by one for every kernel launch and nowhere else;
    ``launches_deep`` counts those of them on a level with C > ``DEEP_C``
    children (the TPU's ``PhaseOperatorResident`` regime).  The library is
    built at the first launch (``cuda_build.load``)."""

    def __init__(self):
        self.launches = 0
        self.launches_deep = 0
        self.build_info: dict | None = None
        self._fn = None

    def function(self):
        if self._fn is None:
            lib, self.build_info = cuda_build.load("phase")
            fn = lib.k1_phase_round
            fn.argtypes = [ctypes.c_void_p] * 10 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def round(self, op: StencilOperator, x, bp, x_out, z_out, coef: float,
              stream: int):
        """Launch one round on ``stream``: x_out <- x + coef * z and, when
        z_out is given, z_out <- z."""
        fn = self.function()
        err = fn(x.data_ptr(), bp.data_ptr(), op.Fp_t.data_ptr(),
                 op.Xp_t.data_ptr(), op.intra_rows.data_ptr(),
                 op.slot_ptr.data_ptr(), op.slot_idx.data_ptr(),
                 op.src_cu.data_ptr(), x_out.data_ptr(),
                 None if z_out is None else z_out.data_ptr(),
                 coef, op.C, op.U, op.nb, stream)
        if err != 0:
            raise RuntimeError(f"kernel K1 (phase round) launch failed: "
                               f"CUDA error {err}")
        self.launches += 1
        if op.C > DEEP_C:
            self.launches_deep += 1


KERNEL = PhaseKernel()


def _round_coefs(coefs, want_z: bool, dtype: torch.dtype) -> list[float]:
    """Per-round step sizes cast to the state dtype (the trailing 0 is the
    z round), as the TPU kernel's coefficient array was."""
    tail = [0.0] if want_z else []
    return torch.tensor(list(coefs) + tail, dtype=torch.float64
                        ).to(dtype).tolist()


def _check(op: StencilOperator, x_t, bp_t):
    shape = (3, op.C, op.U)
    for name, t in (("x", x_t), ("bp", bp_t)):
        if tuple(t.shape) != shape:
            raise ValueError(f"phase: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"phase: {name} is not contiguous")
        if t.device != op.Fp_t.device or t.dtype != op.Fp_t.dtype:
            raise ValueError(
                f"phase: {name} is {t.dtype} on {t.device}, the operator "
                f"{op.Fp_t.dtype} on {op.Fp_t.device}")


def phase_reference(op: StencilOperator, x_t, bp_t, coefs,
                    want_z: bool = True):
    """Plain PyTorch phase: the same rounds as kernel K1, one ``op._z`` each.

    Returns (x, z), z = D^-1 (b - A x) at the returned x when want_z, else
    None."""
    x, z = x_t, None
    for coef in _round_coefs(coefs, want_z, x_t.dtype):
        z = op._z(x, bp_t)
        x = x + coef * z
    return x, (z if want_z else None)


def phase(op: StencilOperator, x_t, bp_t, coefs, want_z: bool = True):
    """Run one relaxation phase on ``op``'s device.

    Args:
      x_t:   (3, C, U) state, contiguous
      bp_t:  (3, C, U) premultiplied right-hand side D^-1 (b - c_aff)
      coefs: per-round step sizes (1/root_k or omega)
      want_z: add the coef-0 round and return its z; False returns None
    Returns (x_new, z).  CPU tensors run ``phase_reference``; CUDA tensors
    (float32 only) launch kernel K1 once per round.
    """
    _check(op, x_t, bp_t)
    if x_t.device.type == "cpu":
        return phase_reference(op, x_t, bp_t, coefs, want_z)
    if x_t.device.type != "cuda":
        raise ValueError(f"phase: unsupported device {x_t.device}")
    if x_t.dtype != torch.float32:
        raise TypeError(f"kernel K1 takes float32 state, got {x_t.dtype}")
    rounds = _round_coefs(coefs, want_z, x_t.dtype)
    if not rounds:
        return x_t, None
    with torch.cuda.device(x_t.device):
        stream = torch.cuda.current_stream(x_t.device).cuda_stream
        bufs = [torch.empty_like(x_t) for _ in range(min(2, len(rounds)))]
        z = torch.empty_like(x_t) if want_z else None
        src = x_t
        for r, coef in enumerate(rounds):
            dst = bufs[r % 2]          # never the buffer this round reads
            last = r == len(rounds) - 1
            KERNEL.round(op, src, bp_t, dst, z if last else None, coef,
                         stream)
            src = dst
    return src, z

"""The geometric level transfers in the transposed layout (3, C, U): the
restriction R = P^T and the linear prolongation P between a fine level of
Cf children a macro and the coarse level of Cc = Cf / 4 below it.

Tables (``models.semi._transfer_tables``): ``fine_of`` (Cc, 4) int64, the
children of each coarse element; ``parent`` (Cf,) int64; ``pweights`` (Cf,
3, 3), the correction at fine node l of child f being sum_k pweights[f, l,
k] * e[k, parent[f]].  ``check_tables`` holds their shapes and ranges once,
when a solver is built.

``restrict(r, fine_of, pweights, S)`` is P^T (S r): on the phase cycle r is
a phase's z = D^-1 (b - A x) and S the self blocks D (3, 3, Cf, U), so the
residual D z is formed inside the restriction; with no S, r is the residual
itself.  ``prolong_add(x, e, parent, pweights)`` is x + P e.  On a CUDA
tensor each is one launch of a hand-written kernel in
``csrc/transfer.cu`` (it replaces no TPU kernel: the JAX package left the
transfers to XLA), in float32 (``transfer_*_f32``) or float64
(``transfer_*_f64``).  On a CPU tensor the plain PyTorch versions
``restrict_reference`` and ``prolong_add_reference`` run instead, which
are the composition of ``restrict_t`` and ``prolong_t`` the cycle ran
before; they are also what the tests and ``chip_smoke.py`` hold the
kernels against.  There is no fallback: on a CUDA tensor the kernel builds
and launches, or this module raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build
from .stencil import mul_blocks

# the library's entries by state dtype: (restriction, prolongation)
DTYPES = {torch.float32: ("transfer_restrict_f32", "transfer_prolong_add_f32"),
          torch.float64: ("transfer_restrict_f64", "transfer_prolong_add_f64")}
# the kernels' plane offsets inside a (C, U) plane are 32-bit
MAX_PAIRS = 2 ** 31 - 1


def restrict_t(r_fine_t, fine_of, pweights):
    """Transpose-of-prolongation restriction R = P^T in transposed layout:
    (3, Cf, U) -> (3, Cc, U); coarse child c sums the weighted residuals of
    its four children fine_of[c] (Cc, 4)."""
    contrib = torch.einsum("flk,lfu->kfu", pweights, r_fine_t)
    return contrib[:, fine_of].sum(dim=2).contiguous()


def prolong_t(e_coarse_t, parent, pweights):
    """Linear interpolation of the coarse correction, transposed layout:
    (3, Cc, U) -> (3, Cf, U); fine child f reads its parent parent[f]."""
    return torch.einsum("flk,kfu->lfu", pweights,
                        e_coarse_t[:, parent]).contiguous()


def restrict_reference(r_t, fine_of, pweights, S_t=None):
    """Plain PyTorch ``restrict``: P^T (S r), P^T r without S."""
    return restrict_t(mul_blocks(S_t, r_t), fine_of, pweights)


def prolong_add_reference(x_t, e_t, parent, pweights):
    """Plain PyTorch ``prolong_add``: x + P e."""
    return x_t + prolong_t(e_t, parent, pweights)


def check_tables(fine_of, parent, pweights, Cf: int):
    """Raise unless the tables between a fine level of Cf children and the
    coarse level below have their shapes, ``fine_of`` lies in [0, Cf) and
    ``parent`` in [0, Cf / 4): the kernels read these indices unchecked."""
    Cc = Cf // 4
    shapes = {"fine_of": (tuple(fine_of.shape), (Cc, 4)),
              "parent": (tuple(parent.shape), (Cf,)),
              "pweights": (tuple(pweights.shape), (Cf, 3, 3))}
    for name, (got, want) in shapes.items():
        if Cf % 4 or got != want:
            raise ValueError(f"transfer table {name} has shape {got}, "
                             f"expected {want} for {Cf} fine children")
    for name, t, hi in (("fine_of", fine_of, Cf), ("parent", parent, Cc)):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise TypeError(f"transfer table {name} is not a contiguous "
                            f"int64 table")
        if t.numel() and (int(t.min()) < 0 or int(t.max()) >= hi):
            raise IndexError(f"transfer table {name} holds an index outside"
                             f" [0, {hi})")


class TransferKernel:
    """ctypes binding of the restriction and prolongation entries of
    ``csrc/transfer.cu`` with their launch counts.

    ``launches`` grows by one for every kernel launch, of either kernel in
    either dtype, and nowhere else; ``by_entry["restrict"]`` and
    ``by_entry["prolong_add"]`` by one for a launch of that kernel.  A CUDA
    graph's replay adds to both what its capture recorded
    (``ops.cuda_graph``); ``utils.tracing.snapshot`` reports ``launches``
    as the kernel ``transfer``.  The library is built at the first launch
    (``cuda_build.load``)."""

    # the launch counters (a CUDA graph's replay adds to them)
    COUNTERS = ("launches", "by_entry")
    ENTRIES = ("restrict", "prolong_add")

    def __init__(self):
        self.reset()
        self.build_info: dict | None = None
        self._lib = None

    def reset(self):
        """Set every count to 0."""
        self.launches = 0
        self.by_entry = dict.fromkeys(self.ENTRIES, 0)

    def function(self, name: str):
        """The library's entry ``name`` (built and bound at the first
        call)."""
        if self._lib is None:
            lib, self.build_info = cuda_build.load("transfer")
            for entry in (e for pair in DTYPES.values() for e in pair):
                fn = getattr(lib, entry)
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return getattr(self._lib, name)

    def launch(self, entry: int, args: tuple, Cf: int, U: int, device):
        """Launch entry 0 (restriction) or 1 (prolongation) of the dtype
        of args[0] on ``device``'s current stream with the five tensors or
        None of ``args``."""
        name = DTYPES[args[0].dtype][entry]
        fn = self.function(name)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*(None if a is None else a.data_ptr() for a in args),
                     Cf, U, stream)
        if err != 0:
            raise RuntimeError(f"transfer kernel {name} (Cf = {Cf}, U = {U})"
                               f" launch failed: CUDA error {err}")
        self.launches += 1
        self.by_entry[self.ENTRIES[entry]] += 1


KERNEL = TransferKernel()


def _on_card(what: str, t, values: tuple, table) -> bool:
    """Whether the transfer runs on the card: False for a CPU tensor;
    raises for another device, a dtype the kernels do not take, or
    ``values`` (tensors or None) or the index ``table`` elsewhere than t,
    or values of another dtype."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"the transfer kernels take float32 or float64, got "
                        f"{t.dtype}")
    for o in values:
        if o is not None and (o.device != t.device or o.dtype != t.dtype):
            raise ValueError(f"{what}: operands are {o.dtype} on {o.device} "
                             f"and {t.dtype} on {t.device}")
    if table.device != t.device:
        raise ValueError(f"{what}: the table is on {table.device}, the "
                         f"operands on {t.device}")
    return True


def _check_shapes(what: str, shapes: dict):
    """Raise unless each of ``shapes`` (name: (tensor or None, the shape
    it must have)) has its shape, Cf is a multiple of 4 and the kernels'
    32-bit offsets take the level (``MAX_PAIRS``)."""
    for name, (t, want) in shapes.items():
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {want}")
    _, Cf, U = shapes["the fine level"][1]
    if Cf % 4 or Cf * U > MAX_PAIRS:
        raise ValueError(f"{what}: {Cf} x {U} fine pairs: Cf must be a "
                         f"multiple of 4 and Cf * U at most {MAX_PAIRS}")


def restrict(r_t, fine_of, pweights, S_t=None):
    """P^T (S r) (3, Cf, U) -> (3, Cc, U), P^T r without S (see the
    module's doc): ``restrict_reference`` on the CPU, one kernel launch on
    the card."""
    Cf, U = r_t.shape[-2:]
    _check_shapes("restrict", {
        "the fine level": (r_t, (3, Cf, U)), "S": (S_t, (3, 3, Cf, U)),
        "fine_of": (fine_of, (Cf // 4, 4)), "pweights": (pweights,
                                                         (Cf, 3, 3))})
    if not _on_card("restrict", r_t, (S_t, pweights), fine_of):
        return restrict_reference(r_t, fine_of, pweights, S_t)
    bc = torch.empty((3, Cf // 4, U), dtype=r_t.dtype, device=r_t.device)
    KERNEL.launch(0, (r_t.contiguous(),
                      None if S_t is None else S_t.contiguous(), fine_of,
                      pweights, bc), Cf, U, r_t.device)
    return bc


def prolong_add(x_t, e_t, parent, pweights):
    """x + P e, (3, Cf, U) from the coarse correction e (3, Cc, U):
    ``prolong_add_reference`` on the CPU, one kernel launch on the card
    into a new tensor."""
    Cf, U = x_t.shape[-2:]
    _check_shapes("prolong_add", {
        "the fine level": (x_t, (3, Cf, U)), "e": (e_t, (3, Cf // 4, U)),
        "parent": (parent, (Cf,)), "pweights": (pweights, (Cf, 3, 3))})
    if not _on_card("prolong_add", x_t, (e_t, pweights), parent):
        return prolong_add_reference(x_t, e_t, parent, pweights)
    out = torch.empty_like(x_t, memory_format=torch.contiguous_format)
    KERNEL.launch(1, (x_t.contiguous(), e_t.contiguous(), parent, pweights,
                      out), Cf, U, x_t.device)
    return out

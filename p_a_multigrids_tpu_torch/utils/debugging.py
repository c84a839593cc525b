"""Debug / sanitizer mode: the checked step (``SemiConfig(debug=True)``,
the CLI's ``--debug``).

The port's counterpart of the JAX package's ``utils/debugging.py``, which
instrumented the jitted step with ``jax.experimental.checkify`` (index
checks on every gather, float checks on NaN/Inf generation) as the
equivalent of the reference's ``-fbounds-check`` debug build.  Here:

- every static index table that the step's gathers and kernels read is
  range-checked once, when the solver is built (``check_index_tables``):
  torch wraps a negative index silently, so this is the port's bounds
  check of the tables;
- the state is asserted finite before each step (``Sanitizer.note_state``);
- on the card the step's K1 and K2 calls launch the checked builds of the
  kernels (``ops.phase.CHECKED``, ``ops.spmv.CHECKED``: ``csrc/*.cu``
  compiled with ``-DPAMG_CHECKED``), which compare every index they read
  with the size it addresses and test every value they write, and record
  the first fault in a small device record (``Sanitizer.record``);
- on the CPU the plain versions run, each followed by a
  ``torch.isfinite(...).all()`` check of its outputs (``Site.check_finite``).

``checked(step, sanitizer)`` wraps a step: after it, the record is read
once (one synchronisation a step) and the first fault raises
``FloatingPointError`` (a non-finite state or value) or ``IndexError``
(an index out of range), naming the kernel, the operator and its level,
and the position.  A clean checked run gives exactly the unchecked run's
numbers: the checks read values, they change none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the record's fields (csrc/checked.cuh Field), then the state flag that
# note_state writes
RECORD_FIELDS = ("flag", "kernel", "kind", "site", "pos", "sub", "value",
                 "bound")
STATE = len(RECORD_FIELDS)
KINDS = {1: "index", 2: "non-finite"}
KERNELS = {1: "K1 (relaxation phase, csrc/phase.cu)",
           2: "K2 (block-row SpMV, csrc/spmv.cu)"}
# what K1 records as `sub` (csrc/phase.cu kSub*)
K1_SUBS = ("intra (face 0)", "intra (face 1)", "intra (face 2)", "slot_ptr",
           "the child's slot count", "slot_idx (slot 0)",
           "slot_idx (slot 1)", "slot_idx (slot 2)", "src (slot 0)",
           "src (slot 1)", "src (slot 2)")


def assert_finite(x, name: str = "array") -> None:
    """Host-side finite assertion for run boundaries (IC, final state)."""
    a = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if not np.isfinite(a).all():
        bad = int((~np.isfinite(a)).sum())
        raise FloatingPointError(
            f"{name}: {bad}/{a.size} non-finite values "
            f"(min={np.nanmin(a)}, max={np.nanmax(a)})")


@dataclasses.dataclass(eq=False)
class Site:
    """One operator that the checked step runs through a kernel: its
    sanitizer, its number in the error record and its name.  Sites
    compare by identity (``ops/agg`` captures a CUDA graph again when
    the sites of its operators are no longer those its capture saw)."""
    sanitizer: "Sanitizer"
    index: int
    name: str
    U: int = 0          # macros of a K1 level (positions are c*U + u)

    def check_finite(self, kernel: int, *outs) -> None:
        """The CPU's check after a plain version's call: its outputs
        finite, else FloatingPointError."""
        for t in outs:
            if t is not None and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{KERNELS[kernel]}, plain version on the CPU, at "
                    f"{self.name}: {int((~torch.isfinite(t)).sum())} "
                    f"non-finite values in its output")


class Sanitizer:
    """The error record of a checked solver and the names of its sites.

    ``record`` is an int32 tensor on the solver's device: the fields of
    ``RECORD_FIELDS`` that a checked kernel fills at its first fault, then
    the state flag of ``note_state``."""

    def __init__(self, device):
        self.record = torch.zeros(STATE + 1, dtype=torch.int32,
                                  device=device)
        self.sites: list[Site] = []

    def site(self, name: str, U: int = 0) -> Site:
        s = Site(self, len(self.sites), name, U)
        self.sites.append(s)
        return s

    def note_state(self, T, name: str = "state before the step") -> None:
        """The state asserted finite: at once on the CPU; on the card into
        the record's state flag (no synchronisation), read by
        ``raise_on_fault``."""
        if T.device.type == "cpu":
            assert_finite(T, name)
        else:
            self.record[STATE].copy_((~torch.isfinite(T)).any())

    def raise_on_fault(self) -> None:
        """Read the record (one synchronisation on the card) and raise for
        its fault, if any, after zeroing it."""
        rec = self.record.tolist()
        if not (rec[0] or rec[STATE]):
            return
        self.record.zero_()
        if rec[STATE]:
            raise FloatingPointError(
                "state before the step: non-finite values (checked step)")
        f = dict(zip(RECORD_FIELDS, rec))
        site = self.sites[f["site"]]
        kernel = KERNELS.get(f["kernel"], f"kernel {f['kernel']}")
        where = f"{kernel}, checked build, at {site.name}"
        if f["kernel"] == 1:
            pos = (f"pair {f['pos']} (child {f['pos'] // site.U}, macro "
                   f"{f['pos'] % site.U})")
        else:
            pos = f"row {f['pos']}"
        if KINDS.get(f["kind"]) == "index":
            table = (K1_SUBS[f["sub"]] if f["kernel"] == 1
                     and 0 <= f["sub"] < len(K1_SUBS)
                     else f"cols (slot {f['sub']})")
            raise IndexError(
                f"{where}: {table} of {pos} holds {f['value']}, outside "
                f"[0, {f['bound']}) (the kernel's error record)")
        # a non-finite value's bits as a float32, in float64 runs too: the
        # kernels store (float)v, which keeps an Inf or a NaN one
        value = np.int32(f["value"]).view(np.float32)
        what = (("x", "z")[f["sub"] // 3] + f" dof {f['sub'] % 3}"
                if f["kernel"] == 1 else f"y dof {f['sub']}")
        raise FloatingPointError(
            f"{where}: wrote {value} as {what} of {pos} (the kernel's error "
            f"record)")


def checked(fn, sanitizer: Sanitizer):
    """Wrap a step ``fn(state) -> state`` so that the state is asserted
    finite before it and the error record is read after it: the first
    fault raises (``Sanitizer.raise_on_fault``)."""
    def wrapper(T):
        sanitizer.note_state(T)
        out = fn(T)
        sanitizer.raise_on_fault()
        return out
    return wrapper


def _index_bounds(module, name: str, owner):
    """[lo, hi) of the index table ``name`` of ``module``, or None when no
    bound is known for it."""
    from ..models.semi import SemiSolver
    from ..ops.fused import FusedOperator
    from ..ops.spmv import RowOp
    from ..ops.stencil import StencilOperator

    if isinstance(module, StencilOperator):
        C, U, nb = module.C, module.U, module.nb
        return {"intra_rows": (0, C), "src_cu": (0, C * U),
                "bnd_c": (0, C), "slot_idx": (0, nb),
                "slot_ptr": (0, nb + 1)}.get(name)
    if isinstance(module, RowOp):
        return {"cols_t": (0, module.n_src)}.get(name)
    if isinstance(module, FusedOperator):
        C, U = module.C, module.U
        return {"intra_rows": (0, 3 * C), "grad_rows": (0, C),
                "bnd_c": (0, C), "slot_of": (0, max(module.nb, 1)),
                "halo_idx": (0, C * U), "halo_perm": (0, 3),
                "own_rows": (0, 3 * C)}.get(name)
    if isinstance(module, SemiSolver):
        kind, _, li = name.rpartition("_")
        if kind in ("fine_of", "parent") and li.isdigit():
            li = int(li)
            C_of = [int(L["C"]) for L in owner.p.levels]
            return (0, C_of[li - 1] if kind == "fine_of" else C_of[li])
    return None


def check_index_tables(solver) -> int:
    """Range-check every integer buffer of ``solver``'s module tree (the
    stencil operators' and the fused operators' gather tables, every K2
    operator's columns, the transfer tables) and the level tables of its
    plain operator (``neigh_elem``, ``neigh_perm``), once; returns the
    number of tables checked.  An index outside its range raises
    IndexError; an integer table with no known range raises TypeError, so
    that a new table cannot go unchecked."""
    from ..ops.stencil import StencilOperator

    n = 0
    for mname, module in solver.named_modules():
        for bname, buf in module.named_buffers(recurse=False):
            if buf is None or buf.dtype.is_floating_point or (
                    buf.dtype == torch.bool):
                continue
            bounds = _index_bounds(module, bname, solver)
            where = f"{mname or type(solver).__name__}.{bname}"
            if bounds is None:
                raise TypeError(f"check_index_tables: no range known for the "
                                f"index table {where}")
            _check_range(where, buf, *bounds)
            n += 1
        if isinstance(module, StencilOperator) and module.nb:
            ptr = module.slot_ptr
            if bool((ptr[1:] < ptr[:-1]).any()) or int(ptr[-1]) != module.nb:
                raise IndexError(f"{mname}.slot_ptr is not a partition of "
                                 f"the {module.nb} slots")
    for li, Lt in enumerate(getattr(solver, "_levels_t", None) or []):
        U, C = Lt["M"].shape[0], Lt["updown"].shape[0]
        _check_range(f"level {li} neigh_elem", Lt["neigh_elem"], -1, U * C)
        _check_range(f"level {li} neigh_perm", Lt["neigh_perm"], 0, 3)
        n += 2
    L0 = getattr(solver, "_L0", None)
    if L0 is not None:
        U, C = L0["M"].shape[0], L0["updown"].shape[0]
        _check_range("level 0 neigh_elem", L0["neigh_elem"], -1, U * C)
        _check_range("level 0 neigh_perm", L0["neigh_perm"], 0, 3)
        n += 2
    return n


def _check_range(where: str, t: torch.Tensor, lo: int, hi: int) -> None:
    if t.numel() and (int(t.min()) < lo or int(t.max()) >= hi):
        raise IndexError(f"{where}: index {int(t.min())}..{int(t.max())} "
                         f"outside [{lo}, {hi})")


def attach(solver) -> Sanitizer:
    """Make ``solver``'s step a checked step: check its index tables, give
    each of its K1 operators (StencilOperator) and K2 operators (RowOp) a
    site of a new Sanitizer, and return the sanitizer."""
    from ..ops.spmv import RowOp
    from ..ops.stencil import StencilOperator

    check_index_tables(solver)
    san = Sanitizer(solver.device)
    for mname, module in solver.named_modules():
        if isinstance(module, StencilOperator):
            level = mname.rpartition(".")[2]
            module.sanitizer = san.site(
                f"level {level} ({mname}: C = {module.C}, U = {module.U})",
                module.U)
        elif isinstance(module, RowOp):
            module.sanitizer = san.site(
                f"{mname} ({module.n_out} x {module.D} blocks, "
                f"{module.n_src} source rows)")
    return san

"""Carry a solver and its state across from the JAX package, through numpy.

``solver_from_numpy`` builds this port's ``SemiSolver`` from the host arrays
a JAX ``SemiSolver`` holds — its per-level ``StencilData`` and
``levels[i]["_np"]`` tables, ``_lam_max``, ``_coarse_inv_np``,
``analytical`` and the SA hierarchy ``_agg`` — given as plain numpy or
duck-typed objects (the transport solvers of modes 2-6 are SemiSolvers
too).  On the non-stencil path (no stencil given) it takes ``_lam_max``,
``_block_inv`` and the dense coarse inverse ``_coarse_inv`` instead.
``assembled_from_numpy`` builds the mode-10 ``AssembledSemiSolver`` from a
JAX one's ``A_bsr``, ``offset`` and level-0 stencil, and
``rect_from_numpy`` mode 1's ``RectProblem`` from a JAX one's mesh and
``tables``.  Nothing here imports JAX.  A state T of shape (U, C, 3) moves both ways as a numpy array
(``state_to_numpy`` / ``state_from_numpy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import RectConfig, SemiConfig
from .models import transport_rect
from .models.semi import SemiProblem, SemiSolver
from .models.semi_assembled import AssembledSemiSolver
from .ops.agg import HostHierarchy, HostLevel
from .ops.bsr import BSR
from .ops.stencil import StencilData


def agg_from_numpy(h) -> HostHierarchy:
    """An SA hierarchy with the fields of the JAX package's
    ``ops.agg.AggHierarchy`` (arrays of any array type) -> this port's
    ``HostHierarchy`` of numpy tables."""
    arr = lambda a: None if a is None else np.asarray(a)
    levels = [HostLevel(**{f.name: (getattr(lv, f.name)
                                    if f.name in ("n", "omega")
                                    else arr(getattr(lv, f.name)))
                           for f in dataclasses.fields(HostLevel)})
              for lv in h.levels]
    fine = None
    if h.fine is not None:
        fine = {k: (float(h.fine[k]) if k == "w" else arr(h.fine[k]))
                for k in ("w", "dinv_t", "r_cols", "r_vals", "p_cols",
                          "p_vals")}
    return HostHierarchy(levels=levels, coarse_inv=arr(h.coarse_inv),
                         coarse_scale=arr(h.coarse_scale),
                         omega=float(h.omega), sweeps=int(h.sweeps),
                         fine=fine)


def _stencil_data(d) -> StencilData:
    return StencilData(**{f.name: (None if getattr(d, f.name, None) is None
                                   else np.asarray(getattr(d, f.name)))
                          for f in dataclasses.fields(StencilData)})


def _problem(cfg, levels, analytical, grid, coords_fine) -> SemiProblem:
    lv = [dict(L["_np"], C=int(L["C"]), s=int(L["s"])) for L in levels]
    return SemiProblem(grid=grid, cfg=cfg, levels=lv,
                       coords_fine=coords_fine,
                       analytical=np.asarray(analytical, cfg.dtype))


def solver_from_numpy(cfg: SemiConfig, levels, stencil, lam_max,
                      coarse_inv, analytical, device, grid=None,
                      coords_fine=None, agg=None,
                      block_inv=None) -> SemiSolver:
    """Port ``SemiSolver`` on ``device`` from another solver's host arrays.

    Args:
      cfg:        this port's SemiConfig, set as the other solver's was.
      levels:     per level a mapping with "s", "C" and "_np" (the host
                  tables ``build_problem`` made, level 0 with "source").
      stencil:    per level an object with the fields of ``StencilData``
                  (unpacked levels only); None on the non-stencil path.
      lam_max:    per-level spectral bounds, or None (not Chebyshev).
      coarse_inv: the dense coarsest-level inverse, or None.
      block_inv:  the non-stencil path's per-level exact diagonal-block
                  inverses (U, C, 3, 3), or None (built from ``levels``;
                  only Chebyshev and block-Jacobi use them).
      analytical: (U, C, 3) exact solution.
      grid, coords_fine: the numpy grid and finest child coordinates, used
                  only by ``initial_condition``.
      agg:        the other solver's SA hierarchy (``agg_from_numpy``'s
                  input); None builds it from ``stencil`` where ``cfg``
                  engages SA.  The level it corrects follows from ``cfg``.
    """
    problem = _problem(cfg, levels, analytical, grid, coords_fine)
    host = dict(lam_max=None if lam_max is None else list(lam_max),
                coarse_inv=(None if coarse_inv is None
                            else np.asarray(coarse_inv)))
    if stencil is None:
        host["block_inv"] = (None if block_inv is None
                             else [np.asarray(B) for B in block_inv])
    else:
        host["stencil"] = [_stencil_data(d) for d in stencil]
    if agg is not None:
        host["agg"] = agg_from_numpy(agg)
    return SemiSolver(problem, device, host=host)


def rect_from_numpy(cfg: RectConfig, x_all, face_ele, tables, device
                    ) -> transport_rect.RectProblem:
    """Port mode 1's ``RectProblem`` on ``device`` from another one's mesh
    (x_all (E, 2, 4), face_ele (E, 4)) and step tables (a mapping with
    ``transport_rect.TABLE_KEYS``, arrays of any array type)."""
    host = {k: np.asarray(tables[k]) for k in transport_rect.TABLE_KEYS}
    return transport_rect.RectProblem(
        cfg=cfg, x_all=np.asarray(x_all), face_ele=np.asarray(face_ele),
        tables=transport_rect.tables_on(host, cfg.dtype, device))


def assembled_from_numpy(cfg: SemiConfig, levels, cols, vals, offset,
                         stencil0, analytical, device, grid=None,
                         coords_fine=None) -> AssembledSemiSolver:
    """Port ``AssembledSemiSolver`` (mode 10) on ``device`` from another
    assembled solver's host arrays.

    Args:
      cfg:        this port's SemiConfig, set as the other solver's was.
      levels:     as for ``solver_from_numpy`` (level 0 is used).
      cols, vals: the assembled BSR matrix, (E, K) and (E, K, 3, 3).
      offset:     (U, C, 3) affine Dirichlet-ghost offset.
      stencil0:   level 0's ``StencilData``-like block stencil.
      analytical, grid, coords_fine: as for ``solver_from_numpy``.
    """
    host = dict(stencil0=_stencil_data(stencil0),
                A_bsr=BSR(cols=np.asarray(cols, np.int32),
                          vals=np.asarray(vals)),
                offset=np.asarray(offset))
    return AssembledSemiSolver(
        _problem(cfg, levels, analytical, grid, coords_fine), device,
        host=host)


def state_from_numpy(solver: SemiSolver, T: np.ndarray) -> torch.Tensor:
    """(U, C, 3) numpy state -> tensor in the solver's dtype and device."""
    return torch.as_tensor(np.asarray(T), dtype=solver.dtype,
                           device=solver.device)


def state_to_numpy(T: torch.Tensor) -> np.ndarray:
    """(U, C, 3) tensor -> numpy array on the host."""
    return T.detach().cpu().numpy()

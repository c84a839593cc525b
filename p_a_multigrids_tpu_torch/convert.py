"""Carry a solver and its state across from the JAX package, through numpy.

``solver_from_numpy`` builds this port's ``SemiSolver`` from the host arrays
a JAX ``SemiSolver`` holds — its per-level ``StencilData`` and
``levels[i]["_np"]`` tables, ``_lam_max``, ``_coarse_inv_np`` and
``analytical`` — given as plain numpy or duck-typed objects.  Nothing here
imports JAX.  A state T of shape (U, C, 3) moves both ways as a numpy array
(``state_to_numpy`` / ``state_from_numpy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import SemiConfig
from .models.semi import SemiProblem, SemiSolver
from .ops.stencil import StencilData


def solver_from_numpy(cfg: SemiConfig, levels, stencil, lam_max,
                      coarse_inv, analytical, device, grid=None,
                      coords_fine=None) -> SemiSolver:
    """Port ``SemiSolver`` on ``device`` from another solver's host arrays.

    Args:
      cfg:        this port's SemiConfig, set as the other solver's was.
      levels:     per level a mapping with "s", "C" and "_np" (the host
                  tables ``build_problem`` made, level 0 with "source").
      stencil:    per level an object with the fields of ``StencilData``
                  (unpacked levels only).
      lam_max:    per-level spectral bounds, or None (block-Jacobi).
      coarse_inv: the dense coarsest-level inverse, or None.
      analytical: (U, C, 3) exact solution.
      grid, coords_fine: the numpy grid and finest child coordinates, used
                  only by ``initial_condition``.
    """
    lv = [dict(L["_np"], C=int(L["C"]), s=int(L["s"])) for L in levels]
    datas = [StencilData(**{f.name: (None if getattr(d, f.name, None) is None
                                     else np.asarray(getattr(d, f.name)))
                            for f in dataclasses.fields(StencilData)})
             for d in stencil]
    problem = SemiProblem(grid=grid, cfg=cfg, levels=lv,
                          coords_fine=coords_fine,
                          analytical=np.asarray(analytical, cfg.dtype))
    host = dict(stencil=datas,
                lam_max=None if lam_max is None else list(lam_max),
                coarse_inv=(None if coarse_inv is None
                            else np.asarray(coarse_inv)))
    return SemiSolver(problem, device, host=host)


def state_from_numpy(solver: SemiSolver, T: np.ndarray) -> torch.Tensor:
    """(U, C, 3) numpy state -> tensor in the solver's dtype and device."""
    return torch.as_tensor(np.asarray(T), dtype=solver.dtype,
                           device=solver.device)


def state_to_numpy(T: torch.Tensor) -> np.ndarray:
    """(U, C, 3) tensor -> numpy array on the host."""
    return T.detach().cpu().numpy()

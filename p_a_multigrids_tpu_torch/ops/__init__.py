"""Element matrices, the block stencil, kernels K1 (``phase``) and K2
(``spmv``), the level-transfer kernels (``transfer``), smoothers, smoothed
aggregation, Galerkin, dense and Krylov solvers."""

from . import bsr, local_matrices, smoothers

"""p_a_multigrids_tpu_torch — the PyTorch/CUDA port of p_a_multigrids_tpu.

The JAX package beside it is the reference: every module here mirrors a
module of the same name there and is held against it by the tests
(``tests/test_torch_*.py``).  This package imports ``torch``, numpy and
scipy, never ``jax`` and never the JAX package.

The slice ported so far is mode 9 (``Semi_implicit_iterative``) on the
stencil path: host setup (``mesh``, ``utils``, ``ops.local_matrices``,
``ops.stencil`` build), the device stencil operator, the relaxation-phase
kernel K1 (``ops/phase.py`` + ``csrc/phase.cu``), the geometric V-cycle and
PCG (``models.semi``, ``ops.krylov``) and the mode-9 CLI (``__main__``).
"""

__version__ = "0.1.0"

import torch as _torch

# Full f32 matmul precision everywhere.  On the TPU, matmuls that truncated
# their inputs made the V-cycle diverge (contraction 0.81 on CPU vs 1.00 on
# the TPU for one configuration); TF32 truncates the same way, so the
# transfer contractions and the dense coarse solve run in full f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

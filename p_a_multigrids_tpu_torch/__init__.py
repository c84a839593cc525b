"""p_a_multigrids_tpu_torch — the PyTorch/CUDA port of p_a_multigrids_tpu.

The JAX package beside it is the reference: every module here mirrors a
module of the same name there and is held against it by the tests
(``tests/test_torch_*.py``).  This package imports ``torch``, numpy and
scipy, never ``jax`` and never the JAX package.

It does what the JAX package does, on one NVIDIA H100 or on the CPU:
every reference mode (1-10) through the CLI (``__main__``, every flag of
the JAX CLI, ``--profile`` included); the semi-structured multigrid
(geometric and smoothed-aggregation, V and W cycles, Galerkin coarse
operators) at every split depth, with every solver of the menu, PCG and
BiCGStab and the theta-schemes (``models``, ``ops``); the distributed
solver over ``torch.distributed`` (``parallel``, ``--devices N``); user
problems by expression, ``.geo`` and gmsh meshes, VTU output, checkpoints
and the history pins (``utils``, ``mesh``, ``io``, ``validation``).  On a
CUDA tensor every relaxation phase and block-stencil apply launches K1
(``ops/phase.py`` + ``csrc/phase.cu``) and every block-row product kernel
K2 (``ops/spmv.py`` + ``csrc/spmv.cu``), both built by nvcc for sm_90a at
first use; the mesh loaders are host C++ (``csrc/mesh_accel.cpp``,
``csrc/gmsh_reader.cpp``).  Entry points run on the card unless the caller
asks for the CPU, where the kernels' plain PyTorch versions run.
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

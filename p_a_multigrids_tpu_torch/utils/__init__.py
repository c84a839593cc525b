"""Host-side tables (quadrature, shape functions) and the CUDA build."""

from . import quadrature, shape_functions

"""Host-side tables (quadrature, shape functions) and the CUDA build."""

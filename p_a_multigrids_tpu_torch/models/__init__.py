"""Solvers by mode (mode 9 semi-structured multigrid so far)."""

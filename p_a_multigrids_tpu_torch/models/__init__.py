"""Solvers by mode: the semi-structured multigrid (modes 7-9), the
assembled operator (mode 10), the transport solvers (modes 2-6) and the
rectangular DG advection (mode 1)."""

"""Distributed solvers over ``torch.distributed`` (``--devices N``)."""

from . import halo, partition, solver

"""Distributed solvers over ``torch.distributed`` (``--devices N``)."""

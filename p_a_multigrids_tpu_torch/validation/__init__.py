"""Validation gates of the port: numpy/scipy copies of the JAX package's
``validation/analytical.py``, ``gates.py`` and ``probe.py`` (the port
imports nothing of the JAX package); tests/test_torch_validation.py holds
them bit-identical to the originals."""

from . import analytical, gates, probe

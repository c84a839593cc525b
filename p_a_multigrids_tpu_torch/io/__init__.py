"""Output files of the port: mode 1's curves, VTU files and checkpoints."""

from . import curves, vtu

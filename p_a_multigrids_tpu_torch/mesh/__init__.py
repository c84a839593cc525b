"""Host-side mesh tables (numpy): splitting lattice, topology, levels."""

from . import geometry, gmsh, splitting, structured, topology

"""Host-side mesh tables (numpy): splitting lattice, topology, levels."""

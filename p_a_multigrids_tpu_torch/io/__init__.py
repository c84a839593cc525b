"""Output files of the port (curves of mode 1)."""

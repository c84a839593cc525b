"""Element matrices, the block stencil, the phase kernel K1 and Krylov."""

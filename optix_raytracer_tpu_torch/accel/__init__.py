"""Triangle geometry and brute-force intersection (kernels 1 and 2)."""

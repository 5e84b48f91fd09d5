"""Attention ops: the plain reference and the three hand-written kernels."""

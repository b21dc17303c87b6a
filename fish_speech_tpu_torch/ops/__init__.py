"""Sampling, int8 quantization and the hand-written kernels' wrappers."""

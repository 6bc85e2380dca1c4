"""Tensor ops of the port: activations, LayerNorm, attention routing, and
the hand-written CUDA kernels under :mod:`.kernels`."""

"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the wrappers around them."""

"""PyTorch + CUDA port of the channel-wise mixed-precision system.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``api/``,
``kernels/``, ``models/``, ``data/``) module for module, and imports
nothing of it, nor JAX.  This slice covers the deployed serving path of the
four MLPerf-Tiny models: deploy -> packed ``QTensor`` -> the fused
mixed-precision GEMM written in CUDA for Hopper (``kernels/csrc``).
"""

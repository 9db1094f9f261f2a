"""PyTorch/CUDA port of the real-time related-query suggestion engine.

Mirrors the JAX package's layout (``core/``, ``data/``, ``kernels/``) and
public names. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CUDA every kernel site launches a hand-written Hopper
kernel (``kernels/csrc``), on the CPU it runs the kernel's plain torch
version.
"""

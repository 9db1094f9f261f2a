"""Peak rates of the NVIDIA H100 SXM (one card), for the roofline terms.

Port of the constants of the JAX package's ``launch/mesh.py``, which are
TPU v5e figures; the mesh functions come with sharding. Every figure is
the data sheet's peak: a card held below its 700 W power limit runs
slower under load, so a measured time is reported beside the card's name
and power limit.
"""
from __future__ import annotations

# HBM3 bandwidth (NVIDIA H100 Tensor Core GPU data sheet, SXM5: 3.35 TB/s).
HBM_BW = 3.35e12                 # B/s
# f32 on the CUDA cores, outside the tensor cores (data sheet: 67 TFLOP/s
# FP32, an FMA counted as two operations).
PEAK_FLOPS_F32 = 67e12           # FLOP/s
# bf16 on the tensor cores, dense (data sheet: 1,979 TFLOP/s with
# sparsity, half of it dense).
PEAK_FLOPS_BF16 = 989e12         # FLOP/s
# NVLink 4: 18 links of 50 GB/s, 900 GB/s a card (data sheet), per link.
NVLINK_BW_PER_LINK = 50e9        # B/s

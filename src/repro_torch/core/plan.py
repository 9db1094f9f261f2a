"""Store sizing derived from the configuration.

Port of ``default_region_width`` from the JAX package's ``core/plan.py``.
The rest of that module (``TunedPlan``, the per-op kernel choice) has no
counterpart here: on CUDA every hot path runs its kernel.
"""
from __future__ import annotations


def default_region_width(cooc_capacity: int) -> int:
    """Default pairs-per-region derived from the cooc capacity.

    {2^16: 16, 2^18: 32, 2^20: 64, >= 2^22: 128}: width grows with the
    square root of capacity (bigger stores hold fatter heads), clamped to
    [8, 128], the widths the region kernels keep in registers.
    """
    if cooc_capacity <= 0:
        raise ValueError(f"bad cooc_capacity {cooc_capacity}")
    log2c = cooc_capacity.bit_length() - 1
    return 1 << min(7, max(3, log2c // 2 - 4))

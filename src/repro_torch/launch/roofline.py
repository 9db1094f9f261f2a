"""Distance to the roofline of one measured hot-path op.

Port of the hot-path half of the JAX package's ``launch/roofline.py``
(``hot_path_roofline``), with the same row fields, at the H100 peaks of
:mod:`.mesh`. The default compute peak is the f32 CUDA-core rate, because
the engine's hot paths are f32 sweeps off the tensor cores; JAX's default
is its TPU bf16 constant. ``analyze``, ``Roofline`` and the HLO parsers
come with the dry run.
"""
from __future__ import annotations

from typing import Dict, Optional

from .mesh import HBM_BW, PEAK_FLOPS_F32


def hot_path_roofline(name: str, *, bytes_touched: float, flops: float,
                      measured_us: float, peak: Optional[float] = None,
                      hbm: Optional[float] = None) -> Dict:
    """Roofline row of one op: its ceiling is ``max(bytes / hbm, flops /
    peak)`` (one device, no collectives; ``autotune.hot_path_traffic``
    gives the analytic bytes and flops), and ``roofline_fraction`` is the
    ceiling over the measured time (1.0: as fast as the card allows)."""
    peak = peak or PEAK_FLOPS_F32
    hbm = hbm or HBM_BW
    t_mem = bytes_touched / hbm
    t_comp = flops / peak
    t_ceiling = max(t_mem, t_comp, 1e-30)
    t_meas = measured_us * 1e-6
    return {
        "op": name,
        "bytes_touched": bytes_touched,
        "model_flops": flops,
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_measured_s": t_meas,
        "bottleneck": "memory" if t_mem >= t_comp else "compute",
        "roofline_fraction": t_ceiling / max(t_meas, 1e-30),
    }

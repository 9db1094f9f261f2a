"""Plain torch versions of the ported kernels.

Each function defines the exact semantics its CUDA kernel reproduces. The
wrappers run them for CPU tensors; ``chip_smoke.py`` and the CUDA tests hold
each kernel against them on the card. Ports of the JAX package's
``kernels/ref.py`` oracles of the same names.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .assoc_score import score_body


def decay_prune_multi_ref(key_hi, key_lo, weight_lanes: Sequence[torch.Tensor],
                          aux_lanes: Sequence[torch.Tensor], decay_factor,
                          threshold):
    """Decay every weight lane, prune on the primary, clear aux lanes and
    keys on pruned slots.

    Returns (key_hi', key_lo', weight_lanes', aux_lanes', live_count,
    total_w).
    """
    live = (key_hi != 0) | (key_lo != 0)
    w0 = weight_lanes[0] * decay_factor
    keep = live & (w0 >= threshold)
    w_out = tuple(torch.where(keep, w * decay_factor, torch.zeros_like(w))
                  for w in weight_lanes)
    a_out = tuple(torch.where(keep, a, torch.zeros_like(a)) for a in aux_lanes)
    zk = torch.zeros_like(key_hi)
    return (torch.where(keep, key_hi, zk), torch.where(keep, key_lo, zk),
            w_out, a_out, keep.sum(dtype=torch.int32), w_out[0].sum())


def score_gate_ref(w_ab, c_ab, w_a, w_b, c_a, c_b, ok, total_w, total_c,
                   coefs: Tuple[float, float, float, float],
                   min_pair_weight: float, min_src_weight: float,
                   min_pair_count: float):
    """Gated combined score; ``-inf`` where any evidence gate fails.

    ``w_ab`` is the effective pair weight: under the lazy policy the caller
    decays it to ``now`` first (the kernel fuses that in-pass).
    """
    score = score_body(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c, coefs)
    gate = (ok & (w_ab >= min_pair_weight) & (c_ab >= min_pair_count)
            & (w_a >= min_src_weight))
    return torch.where(gate, score, torch.full_like(score, -torch.inf))


def bucket_topk_ref(grid: torch.Tensor, k: int):
    """Row-wise top-k by a stable descending sort: the lowest column wins
    ties, the same rule as ``lax.top_k`` and the kernel. Rounds past the
    row's finite entries give ``-inf`` and the sentinel column ``L``.

    Returns (vals f32[R, k], args i32[R, k]).
    """
    R, L = grid.shape
    vals, idx = torch.sort(grid, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    if k > L:
        vals = torch.cat([vals, vals.new_full((R, k - L), -torch.inf)], 1)
        idx = torch.cat([idx, idx.new_full((R, k - L), L)], 1)
    args = torch.where(vals > -torch.inf, idx, torch.full_like(idx, L))
    return vals, args.to(torch.int32)

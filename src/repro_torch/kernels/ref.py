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


def region_rank_ref(w_ab, c_ab, w_a, w_b, c_a, c_b, ok, total_w, total_c,
                    k: int, coefs: Tuple[float, float, float, float],
                    min_pair_weight: float, min_src_weight: float,
                    min_pair_count: float):
    """Score, gate and per-region top-k over the ``[R, W]`` grid: the jnp
    branch of the JAX ``ranking_cycle_region``. ``w_a``/``c_a`` are the
    sources' marginals, one per region row (f32[R]); ``w_ab`` is the
    effective pair weight, as in :func:`score_gate_ref`.

    Returns (vals f32[R, k], args i32[R, k], npass i32[R]): top-k with the
    lowest column winning ties (exhausted rounds: ``-inf`` and the
    sentinel column W), and the gate-passing slots per region.
    """
    w_a = w_a[:, None].expand_as(w_ab)
    c_a = c_a[:, None].expand_as(w_ab)
    score = score_body(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c, coefs)
    gate = (ok & (w_ab >= min_pair_weight) & (c_ab >= min_pair_count)
            & (w_a >= min_src_weight))
    grid = torch.where(gate, score, torch.full_like(score, -torch.inf))
    vals, args = bucket_topk_ref(grid, k)
    return vals, args, gate.sum(1, dtype=torch.int32)


def chain_find_ref(key_hi_r, key_lo_r, regs, dst_hi, dst_lo, active):
    """Global slot (region * W + position) of each row's dst key along its
    chain ``regs`` i32[B, MC] (-1 = no region at that depth), or -1.

    A port of the JAX ``stores._chain_find_jnp`` as a bounded loop over
    the depths: the first hit wins, and within a region the lowest
    matching position. A row skips a -1 depth; chains are -1-terminated
    prefixes, so that equals ending its walk there. The loop stops once
    no row has a region left to visit. Returns i32[B].
    """
    B, MC = regs.shape
    W = key_hi_r.shape[1]
    found = torch.full((B,), -1, dtype=torch.int32, device=regs.device)
    for d in range(MC):
        pending = active & (found < 0)
        if not bool((pending[:, None] & (regs[:, d:] >= 0)).any()):
            break
        col = regs[:, d]
        rows = (pending & (col >= 0)).nonzero().squeeze(1)
        reg = col[rows].long()
        m = (key_hi_r[reg] == dst_hi[rows, None]) \
            & (key_lo_r[reg] == dst_lo[rows, None])
        hit = m.any(1)
        pos = torch.argmax(m.to(torch.uint8), 1)     # the first match
        found[rows[hit]] = (reg * W + pos)[hit].to(torch.int32)
    return found

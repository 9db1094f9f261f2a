"""Decode KV caches: full-length and sliding-window (ring buffer).

Port of the JAX package's ``models/kv_cache.py``. Cache layout per layer:

  full:    {"k": [B, T_max, Hkv, D], "v": same, "pos": [B] int32,
            "window": int32 scalar 0}
  window:  {"k": [B, W, Hkv, D], "v": same, "pos": [B] int32,
            "window": int32 scalar W}  (ring)

``pos`` is the number of tokens already written (the next write index).
The transformer stacks the layers on a leading dim (``init_caches``) and
hands each layer its slice.

The writes here update ``k``, ``v`` and ``pos`` IN PLACE and return the
same dict; the JAX functions return new arrays (and rely on buffer
donation to update in place). A caller that needs the pre-write cache
copies it first.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def init_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               dtype, *, window: int = 0, device="cuda") -> Dict:
    L = window if window > 0 else max_len
    return {
        "k": torch.zeros((batch, L, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, L, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "window": torch.tensor(window, dtype=torch.int32, device=device),
    }


def cache_read_state(cache: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute positions [B, L] and validity of the PRE-write cache slots
    (the two-piece decode attention never concatenates the cache with the
    fresh keys)."""
    B, L = cache["k"].shape[0], cache["k"].shape[1]
    is_ring = cache["window"] > 0
    pre_pos = cache["pos"][:, None]
    slot = torch.arange(L, dtype=torch.int32, device=pre_pos.device)[None, :]
    ring_age = torch.remainder(pre_pos - 1 - slot, L)
    ring_abs = pre_pos - 1 - ring_age
    full_abs = slot.expand(B, L)
    kpos = torch.where(is_ring, ring_abs, full_abs)
    valid = (kpos >= 0) & (kpos < pre_pos)
    return kpos, valid


def cache_write(cache: Dict, k_new, v_new, positions) -> Dict:
    """Scatter T fresh tokens into the cache, in place; a ring keeps the
    last min(T, L) and a full cache drops positions past its end (the JAX
    ``.at[...].set(mode="drop")``)."""
    B, T = k_new.shape[0], k_new.shape[1]
    L = cache["k"].shape[1]
    is_ring = cache["window"] > 0
    new_pos = positions[:, -1:] + 1
    survive = (~is_ring) | (positions >= new_pos - L)
    in_range = is_ring | (positions < L)
    write_idx = torch.where(is_ring, torch.remainder(positions, L), positions)
    keep = survive & in_range & (write_idx >= 0)
    b_idx = torch.arange(B, device=positions.device)[:, None].expand(B, T)
    bi, wi = b_idx[keep], write_idx[keep].long()
    cache["k"][bi, wi] = k_new[keep]
    cache["v"][bi, wi] = v_new[keep]
    cache["pos"].copy_(new_pos[:, 0])
    return cache


def cache_update_and_read(cache: Dict, k_new, v_new, positions
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor, Dict]:
    """Write T new tokens, return (k_all, v_all, k_positions, k_valid,
    cache).

    positions: [B, T] absolute positions of the new tokens (pos ..
    pos+T-1). The pre-write cache is read first (early queries of the chunk
    need keys the write evicts from a ring) and concatenated with the new
    tokens; then the cache is written in place. For the ring layout T <= W
    per call: ``transformer.prefill`` chunks long prompts accordingly.
    """
    B, T = k_new.shape[0], k_new.shape[1]
    pre_kpos, pre_valid = cache_read_state(cache)
    k_all = torch.cat([cache["k"], k_new], dim=1)
    v_all = torch.cat([cache["v"], v_new], dim=1)
    k_positions = torch.cat([pre_kpos, positions.to(pre_kpos.dtype)], dim=1)
    k_valid = torch.cat([pre_valid, torch.ones((B, T), dtype=torch.bool,
                                               device=pre_valid.device)],
                        dim=1)
    cache_write(cache, k_new, v_new, positions)
    return k_all, v_all, k_positions, k_valid, cache

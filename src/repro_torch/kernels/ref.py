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


def assoc_score_ref(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c,
                    coefs: Tuple[float, float, float, float]):
    """Combined association score per slot, no gates and no decay: the
    four lanes of ``assoc_score.assoc_lanes`` in the paper's combination."""
    return score_body(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c, coefs)


def decay_prune_ref(key_hi, key_lo, weight, decay_factor, threshold):
    """Single-lane decay and prune. Returns (key_hi', key_lo', weight',
    keep_mask, live_count, total_w); a kept slot is exactly one whose key
    survives."""
    kh, kl, (w,), _, live, tot = decay_prune_multi_ref(
        key_hi, key_lo, (weight,), (), decay_factor, threshold)
    return kh, kl, w, (kh != 0) | (kl != 0), live, tot


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
    row's finite entries give ``-inf`` and the sentinel column ``L``. A
    row that holds a NaN, of either sign, gives NaN with the sentinel
    column in every round, as the Pallas kernel does (its row max is NaN,
    which no element equals, so no round retires anything); ``lax.top_k``
    instead puts a positive NaN first with its column and a negative NaN
    last.

    Returns (vals f32[R, k], args i32[R, k]).
    """
    R, L = grid.shape
    nan_row = torch.isnan(grid).any(1, keepdim=True)
    vals, idx = torch.sort(grid, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    if k > L:
        vals = torch.cat([vals, vals.new_full((R, k - L), -torch.inf)], 1)
        idx = torch.cat([idx, idx.new_full((R, k - L), L)], 1)
    vals = torch.where(nan_row, torch.full_like(vals, torch.nan), vals)
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


def edit_distance_ref(a_chars, a_len, b_chars, b_len, first_char_cost=1.5):
    """Weighted optimal-string-alignment distance per pair.

    ``a_chars``/``b_chars`` u8[B, L] zero-padded, lengths int[B] in
    [0, L] (clamped there). Edits touching the first character of either
    string cost ``first_char_cost``, all others 1; an adjacent
    transposition is one edit. Returns f32[B].

    A port of the JAX ``ref.edit_distance_ref`` that keeps its operation
    order cell by cell: row 0 as ``fc + (j - 1)``, column 0 built row by
    row as ``D[i-1][0] + 1`` (``fc`` at i = 1), and each of the
    substitution, insertion, deletion and transposition terms as one f32
    add before the mins. Rows are kept as ``[L + 1, B]`` so every step is
    a contiguous vector op, and each pair's result is taken from row
    ``a_len`` as the loop passes it instead of from a stored full table.
    """
    B, L = a_chars.shape
    dev = a_chars.device
    a = a_chars.to(torch.int32).t()          # [L, B]
    b = b_chars.to(torch.int32).t()
    f32 = dict(dtype=torch.float32, device=dev)
    fc = torch.tensor(first_char_cost, **f32)
    one = torch.tensor(1.0, **f32)
    big = torch.tensor(1e9, **f32)
    j_idx = torch.arange(L + 1, **f32)
    row0 = torch.where(j_idx == 0, 0.0, fc + (j_idx - 1.0))
    a_len = a_len.to(torch.int64).clamp(0, L)
    b_len = b_len.to(torch.int64).clamp(0, L)
    out = row0[b_len]
    prev2 = prev1 = row0[:, None].expand(L + 1, B)
    for i in range(1, L + 1):
        ai = a[i - 1]
        del_w = fc if i == 1 else one
        row = torch.empty((L + 1, B), **f32)
        row[0] = fc.expand(B) if i == 1 else prev1[0] + 1.0
        for j in range(1, L + 1):
            bj = b[j - 1]
            sub_w = fc if (i == 1 or j == 1) else one
            ins_w = fc if j == 1 else one
            sub = prev1[j - 1] + torch.where(ai == bj, 0.0, sub_w)
            d = torch.minimum(torch.minimum(sub, row[j - 1] + ins_w),
                              prev1[j] + del_w)
            if i >= 2 and j >= 2:
                tw = fc if (i == 2 or j == 2) else one
                tmatch = (a[i - 2] == bj) & (ai == b[j - 2])
                d = torch.minimum(d, torch.where(tmatch, prev2[j - 2] + tw,
                                                 big))
            row[j] = d
        out = torch.where(a_len == i, row.gather(0, b_len[None])[0], out)
        prev2, prev1 = prev1, row
    return out


def attention_scale(head_dim: int) -> float:
    """``1 / sqrt(D)`` computed in f32, as the JAX reference computes it."""
    return float(torch.tensor(float(head_dim)).sqrt().reciprocal())


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: [B, Hq, Tq, D]; k/v: [B, Hkv, Tk, D]; GQA via Hq % Hkv == 0.

    ``window > 0`` keeps the keys with ``kpos > qpos - window``. Query rows
    are end-aligned (``qpos = i + Tk - Tq``). Scores, softmax and ``P @ V``
    run in f32; returns [B, Hq, Tq, D] in ``q.dtype``. A row with no valid
    key (causal with Tq > Tk) is NaN, as in the JAX reference.
    """
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    scale = attention_scale(D) if scale is None else float(scale)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window and window > 0:
        mask &= kpos > qpos - window
    logits.masked_fill_(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)

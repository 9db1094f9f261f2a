"""Engine-facing wrappers over the kernels (port of the JAX ``kernels/ops.py``).

The CUDA kernels take any capacity, so the JAX wrappers' ragged-capacity
branches are gone; the device of the tensors picks kernel or plain version
(see the package docstring).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import assoc_score as _as
from . import decay_prune as _dp
from . import edit_distance as _ed
from . import flash_attention as _fa
from . import ref
from . import region_probe as _rp
from . import topk_select as _tk


def decay_prune_table(table, dticks, *, cfg, weight_lanes: Tuple[str, ...]):
    """Fused decay/prune sweep over a HashTable (the engine's decay cycle).

    Every 1-D lane rides the one pass: weight lanes are decayed and pruned,
    aux lanes cleared on pruned slots. Returns (table, live_count,
    total_weight); the two scalars are plain reductions over the output
    lanes, as in the reference sweep.
    """
    aux = [n for n in table.lanes if n not in weight_lanes]
    kh, kl, w_out, a_out, live, tot = _dp.decay_prune_multi(
        table.key_hi, table.key_lo,
        tuple(table.lanes[n] for n in weight_lanes),
        tuple(table.lanes[n] for n in aux), cfg.factor(dticks),
        cfg.prune_threshold)
    lanes = dict(zip(weight_lanes, w_out))
    lanes.update(zip(aux, a_out))
    return table._replace(key_hi=kh, key_lo=kl, lanes=lanes), live, tot


def assoc_score(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c, *,
                coefs: Tuple[float, float, float, float]):
    """Fused association scoring over full store lanes (no gates, no
    decay)."""
    return _as.assoc_score(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c,
                           coefs=tuple(float(c) for c in coefs))


def _pre_decay(w_ab, decay_cfg, last_tick, now):
    """(w_ab, half_life): exponential decay runs in the kernel (half_life);
    other kinds pre-decay ``w_ab`` with identical semantics."""
    if decay_cfg is None:
        return w_ab, None
    if decay_cfg.kind == "exp":
        return w_ab, float(decay_cfg.half_life_ticks)
    return w_ab * decay_cfg.factor(torch.clamp_min(now - last_tick, 0)), None


def score_gate(w_ab, c_ab, w_a, w_b, c_a, c_b, ok, total_w, total_c, *,
               coefs: Tuple[float, float, float, float],
               min_pair_weight: float, min_src_weight: float,
               min_pair_count: float, decay_cfg=None, last_tick=None,
               now=None):
    """(Lazy decay +) scoring + gating: the elementwise stage of the
    segmented ranking cycle. Exponential decay runs in the kernel; other
    kinds pre-decay with identical semantics."""
    w_ab, half_life = _pre_decay(w_ab, decay_cfg, last_tick, now)
    return _tk.score_gate(w_ab, c_ab, w_a, w_b, c_a, c_b, ok, last_tick,
                          total_w, total_c, now,
                          coefs=tuple(float(c) for c in coefs),
                          min_pair_weight=float(min_pair_weight),
                          min_src_weight=float(min_src_weight),
                          min_pair_count=float(min_pair_count),
                          half_life=half_life)


def bucket_topk(grid, k: int):
    """Per-bucket top-k over the segmented ranking [R, L] grid (values and
    in-bucket columns); the lowest column wins ties."""
    return _tk.bucket_topk(grid, int(k))


def region_rank(w_ab, c_ab, w_a, w_b, c_a, c_b, ok, total_w, total_c, *,
                k: int, coefs: Tuple[float, float, float, float],
                min_pair_weight: float, min_src_weight: float,
                min_pair_count: float, decay_cfg=None, last_tick=None,
                now=None):
    """The region ranking cycle's fused pass: (lazy decay +) scoring +
    gates + per-region top-k over the ``[R, W]`` grid, with ``w_a``/``c_a``
    one per region (f32[R]). Exponential decay runs in the kernel; other
    kinds pre-decay with identical semantics. Returns (vals, args, npass)."""
    w_ab, half_life = _pre_decay(w_ab, decay_cfg, last_tick, now)
    return _tk.region_rank(w_ab, c_ab, w_a, w_b, c_a, c_b, ok, last_tick,
                           total_w, total_c, now, k=int(k),
                           coefs=tuple(float(c) for c in coefs),
                           min_pair_weight=float(min_pair_weight),
                           min_src_weight=float(min_src_weight),
                           min_pair_count=float(min_pair_count),
                           half_life=half_life)


def chain_find(key_hi_r, key_lo_r, regs, dst_hi, dst_lo, active):
    """Region-layout chain find (the region store's insert and lookup):
    the global slot of each pair's dst key along its chain, or -1."""
    return _rp.chain_find(key_hi_r, key_lo_r, regs, dst_hi, dst_lo, active)


def edit_distance(a_chars, a_len, b_chars, b_len, *,
                  first_char_cost: float = 1.5):
    """Batched weighted OSA edit distance (the spelling job's pairs)."""
    return _ed.edit_distance(a_chars, a_len, b_chars, b_len,
                             first_char_cost=float(first_char_cost))


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through the plain
    version under autograd (the JAX ``custom_vjp`` does the same: no
    backward kernel exists)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _fa.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.flash_attention_ref(q, k, v, causal=ctx.causal,
                                          window=ctx.window)
        return (*torch.autograd.grad(out, (q, k, v), g), None, None)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Causal / sliding-window / GQA attention, q [B, Hq, Tq, D], k/v
    [B, Hkv, Tk, D] (the LM's cache-free forward)."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))

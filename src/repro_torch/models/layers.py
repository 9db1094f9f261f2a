"""Shared model layers: RMS and layer norm, RoPE, GQA attention (full /
sliding-window / qk-norm), SwiGLU, the plain MLP. Port of the JAX package's
``models/layers.py``.

Parameters keep the JAX layout (``x @ w`` with ``w`` [d_in, d_out]) so that
weights carry across unchanged (``models/convert.py``). Attention math
accumulates in f32 whatever the parameter dtype. The JAX sharding
constraints are no-ops without a mesh and are left out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops as kops
from . import kv_cache as kvc


def rms_norm(x, scale, eps=1e-6):
    """Normalise in f32, cast back to x's dtype, then scale in the param
    dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    """Statistics in f32, cast back to x's dtype, then ``* scale + bias``."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


# ---------------------------------------------------------------------------
# JAX's gather rules for ids out of range (torch indexing raises on the CPU
# and asserts on the device instead)
# ---------------------------------------------------------------------------

def _wrap(idx, n: int):
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def take(table, idx):
    """``jnp.take(table, idx, axis=0)`` in JAX's fill mode: an id in [-n, 0)
    counts from the end; any other id outside [0, n) gives a NaN row."""
    n = table.shape[0]
    i = _wrap(idx, n)
    bad = (i < 0) | (i >= n)
    out = table[i.masked_fill(bad, 0)]
    return out.masked_fill_(bad.view(bad.shape + (1,) * (out.dim()
                                                         - bad.dim())),
                            float("nan"))


def clamped(idx, n: int):
    """The ids JAX's bracket gather ``x[idx]`` reads: an id in [-n, 0)
    counts from the end, then every id is clamped into [0, n)."""
    return _wrap(idx, n).clamp_(0, n - 1)


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight made without a gradient: the serving path tracks none, and
    the trainer switches gradients on for the span of a step
    (``training.train_loop.trainable``)."""
    return nn.Parameter(t, requires_grad=False)


def normal_param(gen, shape, scale, dtype, device) -> nn.Parameter:
    """Normal(0, 1) in f32 times ``scale``, cast to ``dtype``: the JAX
    inits' distribution. Without a generator, an uninitialised tensor for a
    caller to fill (``convert.py``)."""
    if gen is None:
        return param(torch.empty(shape, dtype=dtype, device=device))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device) * scale
    return param(w.to(dtype))


def init_linear(gen, d_in, d_out, dtype, device, scale=None):
    """A [d_in, d_out] weight, N(0, 1/d_in) unless ``scale`` is given (the
    JAX ``init_linear``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal_param(gen, (d_in, d_out), scale, dtype, device)


# ---------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., T, H, D]; positions: [..., T] int."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, x.device)                    # (D/2,)
    ang = positions[..., None].float() * inv               # [..., T, D/2]
    cos = torch.cos(ang)[..., None, :]                     # [..., T, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    window: int = 0          # >0: sliding-window attention
    rope_theta: float = 10000.0
    causal: bool = True


class Attention(nn.Module):
    """wq [d, Hq*D], wk/wv [d, Hkv*D], wo [Hq*D, d]; q_norm/k_norm [D] with
    qk-norm."""

    def __init__(self, cfg: AttentionConfig, dtype, device, gen=None):
        super().__init__()
        d, D = cfg.d_model, cfg.head_dim
        shapes = {"wq": (d, cfg.n_heads * D), "wk": (d, cfg.n_kv_heads * D),
                  "wv": (d, cfg.n_kv_heads * D), "wo": (cfg.n_heads * D, d)}
        for name, (d_in, d_out) in shapes.items():
            setattr(self, name, init_linear(gen, d_in, d_out, dtype, device))
        if cfg.qk_norm:
            self.q_norm = param(torch.ones(D, dtype=dtype, device=device))
            self.k_norm = param(torch.ones(D, dtype=dtype, device=device))


ATTN_Q_CHUNK = 1024  # q-block size above which attention is chunked


def _masked_logits(q, k, cfg: AttentionConfig, q_positions, k_positions,
                   k_valid):
    """f32 logits [B, Hkv, rep, T, S] with masked entries at -1e30, and the
    mask [B, T, S]."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    qh = q.reshape(B, T, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bthrd,bshd->bhrts", qh.float(),
                          k.float()) / math.sqrt(D)
    mask = torch.ones((B, T, k.shape[1]), dtype=torch.bool, device=q.device)
    if cfg.causal:
        mask &= k_positions[:, None, :] <= q_positions[:, :, None]
    if cfg.window > 0:
        mask &= k_positions[:, None, :] > q_positions[:, :, None] - cfg.window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    logits.masked_fill_(~mask[:, None, None], -1e30)
    return logits, mask


def _attn_block(q, k, v, cfg: AttentionConfig, q_positions, k_positions,
                k_valid=None):
    """One q-block: q [B,T,Hq,D], k/v [B,S,Hkv,D] -> [B,T,Hq,D] (f32 acc)."""
    B, T, Hq, D = q.shape
    logits, _ = _masked_logits(q, k, cfg, q_positions, k_positions, k_valid)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrts,bshd->bthrd", probs, v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def _attn_piece(q, k, v, cfg: AttentionConfig, q_positions, k_positions,
                k_valid=None):
    """One piece of a split-KV attention: UNNORMALIZED (o, m, l) —
    exp-weighted values, per-query running max and denominator — for
    online-softmax merging across pieces."""
    B, T, Hq, D = q.shape
    logits, mask = _masked_logits(q, k, cfg, q_positions, k_positions,
                                  k_valid)
    m = logits.amax(dim=-1)                           # (B, h, r, T)
    p = torch.exp(logits - m[..., None])
    p = p.masked_fill(~mask[:, None, None], 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhrts,bshd->bthrd", p, v.float())

    def perm(x):
        return x.permute(0, 3, 1, 2).reshape(B, T, Hq)
    return o.reshape(B, T, Hq, D), perm(m), perm(l)


def _attn_math(q, k, v, cfg: AttentionConfig, q_positions, k_positions,
               k_valid=None):
    """Attention over q chunks of :data:`ATTN_Q_CHUNK` rows, so no more
    than [B, chunk, S] logits exist at once (the JAX ``scan`` over chunks
    becomes a loop)."""
    T = q.shape[1]
    chunk = ATTN_Q_CHUNK
    if T <= chunk or T % chunk:
        return _attn_block(q, k, v, cfg, q_positions, k_positions, k_valid)
    return torch.cat([
        _attn_block(q[:, i:i + chunk], k, v, cfg, q_positions[:, i:i + chunk],
                    k_positions, k_valid)
        for i in range(0, T, chunk)], dim=1)


def attention(params: Attention, x, cfg: AttentionConfig, positions,
              cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: [B, T, d]. Without a cache: the flash kernel (CUDA) or its plain
    version (CPU). With a cache: decode (T <= 16, two-piece online softmax)
    or prefill (write then read the cache); the cache is updated in place
    and returned."""
    B, T, _ = x.shape
    q = (x @ params.wq).view(B, T, cfg.n_heads, cfg.head_dim)
    k = (x @ params.wk).view(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ params.wv).view(B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), cfg.causal, cfg.window)
        o = o.transpose(1, 2)
    elif T <= 16:
        # DECODE: cache piece + fresh piece merged by online softmax, with
        # no concatenation of the cache and the fresh tokens.
        pre_kpos, pre_valid = kvc.cache_read_state(cache)
        o1, m1, l1 = _attn_piece(q, cache["k"], cache["v"], cfg, positions,
                                 pre_kpos, pre_valid)
        o2, m2, l2 = _attn_piece(q, k, v, cfg, positions, positions, None)
        m = torch.maximum(m1, m2)
        s1 = torch.exp(m1 - m)
        s2 = torch.exp(m2 - m)
        denom = torch.clamp_min(l1 * s1 + l2 * s2, 1e-30)
        o = ((o1 * s1[..., None] + o2 * s2[..., None]) / denom[..., None]
             ).to(q.dtype)
        cache = kvc.cache_write(cache, k, v, positions)
    else:
        # PREFILL: read the pre-write cache with the chunk, then write.
        k_all, v_all, k_pos, k_valid, cache = kvc.cache_update_and_read(
            cache, k, v, positions)
        o = _attn_math(q, k_all, v_all, cfg, positions, k_pos, k_valid)

    o = o.reshape(B, T, cfg.n_heads * cfg.head_dim)
    return o @ params.wo, cache


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """w_gate, w_up [d, ff]; w_down [ff, d]."""

    def __init__(self, d_model: int, d_ff: int, dtype, device, gen=None):
        super().__init__()
        for name, (d_in, d_out) in {"w_gate": (d_model, d_ff),
                                    "w_up": (d_model, d_ff),
                                    "w_down": (d_ff, d_model)}.items():
            setattr(self, name, init_linear(gen, d_in, d_out, dtype, device))


def swiglu(params: SwiGLU, x):
    return (F.silu(x @ params.w_gate) * (x @ params.w_up)) @ params.w_down


# ---------------------------------------------------------------------------
# Plain MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``w{i}`` [dims[i], dims[i+1]] and, with ``bias``, ``b{i}`` (zeros)."""

    def __init__(self, dims, dtype, device, gen=None, bias=True):
        super().__init__()
        for i in range(len(dims) - 1):
            setattr(self, f"w{i}", init_linear(gen, dims[i], dims[i + 1],
                                               dtype, device))
            if bias:
                setattr(self, f"b{i}", param(torch.zeros(
                    dims[i + 1], dtype=dtype, device=device)))


def init_mlp(gen, dims, dtype, device, bias=True) -> MLP:
    """Plain MLP given [d_in, h1, ..., d_out]."""
    return MLP(dims, dtype, device, gen, bias)


def n_mlp_layers(params: MLP) -> int:
    return sum(1 for name, _ in params.named_parameters()
               if name.startswith("w"))


def mlp(params: MLP, x, n_layers: int, act=F.relu, final_act: bool = False):
    for i in range(n_layers):
        x = x @ getattr(params, f"w{i}")
        b = getattr(params, f"b{i}", None)
        if b is not None:
            x = x + b
        if i < n_layers - 1 or final_act:
            x = act(x)
    return x

"""Dense and MoE causal LM: GQA / sliding-window / qk-norm, forward,
prefill and decode. Port of the JAX package's ``models/transformer.py``.

The JAX ``lax.scan`` over stacked block parameters becomes a loop over an
``nn.ModuleList`` of blocks; the stacked caches stay stacked (a leading
layer dim) and each layer updates its slice in place. Matmuls run in the
config dtype, softmax and norms accumulate in f32. The cache-free forward
runs attention through ``ops.flash_attention``: the hand-written kernel on
CUDA, its plain version on the CPU. A block holds a mixture-of-experts FFN
(``models/moe.py``) where the config has ``moe``.

Training: :func:`loss_fn` is next-token cross entropy plus the MoE router
loss. Where gradients are on, each block runs under the config's
rematerialisation policy (``remat``): ``"full"`` recomputes the block in
the backward pass, ``"dots"`` keeps the outputs of the matrix products
with no batch dimension (the parameter products; JAX's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest,
``"none"`` keeps everything. The sharding rules are JAX's tables, as data:
one card has no mesh to apply them to.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..core.stores import resolve_device
from . import kv_cache as kvc
from .layers import (Attention, AttentionConfig, SwiGLU, attention,
                     init_linear, param, rms_norm, swiglu)
from .moe import MoE, MoEConfig, moe_ffn


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    window: int = 0                   # sliding-window attention width
    rope_theta: float = 10000.0
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"
    remat: str = "full"               # none | full | dots
    tie_embeddings: bool = False
    scan_unroll: int = 1              # JAX scan unroll; no effect here

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            qk_norm=self.qk_norm, window=self.window,
            rope_theta=self.rope_theta, causal=True)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows padded to 256; padded logits are masked to
        -1e30 (never selected)."""
        return ((self.vocab_size + 255) // 256) * 256

    def param_count(self) -> int:
        """Total parameters (N for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.moe:
            ff = 3 * d * self.moe.d_ff * self.moe.n_experts + d * self.moe.n_experts
            if self.moe.n_shared_experts:
                ff += 3 * d * self.moe.shared_d_ff * self.moe.n_shared_experts + d
        else:
            ff = 3 * d * self.d_ff
        norms = 2 * d
        per_layer = attn + ff + norms
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Active parameters per token (N_active for MoE MODEL_FLOPS)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        attn = d * self.hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        ff = 3 * d * self.moe.d_ff * self.moe.top_k + d * self.moe.n_experts
        if self.moe.n_shared_experts:
            ff += 3 * d * self.moe.shared_d_ff * self.moe.n_shared_experts + d
        per_layer = attn + ff + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        dt = cfg.torch_dtype
        self.ln_attn = param(torch.ones(cfg.d_model, dtype=dt, device=device))
        self.ln_ffn = param(torch.ones(cfg.d_model, dtype=dt, device=device))
        self.attn = Attention(cfg.attn, dt, device, gen)
        if cfg.moe:
            self.moe = MoE(cfg.d_model, cfg.moe, dt, device, gen)
        else:
            self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, dt, device, gen)


class LM(nn.Module):
    """embed [Vp, d], blocks, norm_f [d], lm_head [d, Vp] (untied). The
    JAX tree stacks ``blocks`` on a leading layer dim (``STACKED``)."""

    STACKED = "blocks"

    def __init__(self, cfg: LMConfig, device, gen=None):
        super().__init__()
        dt, d, vp = cfg.torch_dtype, cfg.d_model, cfg.padded_vocab
        self.embed = init_linear(gen, vp, d, dt, device, scale=0.02)
        self.blocks = nn.ModuleList(Block(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        self.norm_f = param(torch.ones(d, dtype=dt, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = init_linear(gen, d, vp, dt, device)


def init_params(cfg: LMConfig, *, generator: torch.Generator,
                device="cuda") -> LM:
    """Random parameters with the JAX ``init_params`` distributions: embed
    N(0, 0.02^2), linear weights N(0, 1/d_in), lm_head N(0, 1/d), norms 1;
    an MoE block's as ``moe.init_moe`` draws them (its router in f32).
    ``generator`` must live on ``device``; the numbers differ from JAX's."""
    return LM(cfg, resolve_device(device), generator)


def params_sharding_rules():
    """(path_regex, logical axes per dim) — Megatron-style TP (training).

    Block params are scan-STACKED in the JAX tree: leading dim is the layer
    index, so every blocks/ rule starts with None for the L dim."""
    return [
        (r"embed", ("tp", None)),                      # vocab-sharded
        (r"lm_head", (None, "tp")),
        (r"attn/w[qkv]$", (None, None, "tp")),         # [L, d, H*hd]
        (r"attn/wo$", (None, "tp", None)),             # [L, H*hd, d]
        (r"ffn/w_(gate|up)$", (None, None, "tp")),     # [L, d, ff]
        (r"ffn/w_down$", (None, "tp", None)),          # [L, ff, d]
        # Expert weights: FSDP-style 2D sharding (dp x tp), stored fully
        # sharded, gathered per layer on use.
        (r"moe/router$", (None, None, None)),
        (r"moe/w_(gate|up)$", (None, None, "dp", "tp")),   # [L, E, d, f]
        (r"moe/w_down$", (None, None, "tp", "dp")),        # [L, E, f, d]
        (r"moe/shared/w_(gate|up)$", (None, "dp", "tp")),
        (r"moe/shared/w_down$", (None, "tp", "dp")),
    ]


def serve_sharding_rules():
    """2D (dp x tp) weight sharding for serving: with no optimizer keeping
    params hot per dp replica, weights shard over BOTH axes and are
    gathered per layer as used."""
    return [
        (r"embed", ("tp", "dp")),
        (r"lm_head", ("dp", "tp")),
        (r"attn/w[qkv]$", (None, "dp", "tp")),
        (r"attn/wo$", (None, "tp", "dp")),
        (r"ffn/w_(gate|up)$", (None, "dp", "tp")),
        (r"ffn/w_down$", (None, "tp", "dp")),
        (r"moe/router$", (None, None, None)),
        (r"moe/w_(gate|up)$", (None, None, "dp", "tp")),
        (r"moe/w_down$", (None, None, "tp", "dp")),
        (r"moe/shared/w_(gate|up)$", (None, "dp", "tp")),
        (r"moe/shared/w_down$", (None, "tp", "dp")),
    ]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_apply(block: Block, x, positions, cfg: LMConfig,
                 cache: Optional[Dict]):
    h, cache = attention(block.attn, rms_norm(x, block.ln_attn), cfg.attn,
                         positions, cache)
    x = x + h
    if cfg.moe:
        h, aux = moe_ffn(block.moe, rms_norm(x, block.ln_ffn), cfg.moe)
    else:
        h, aux = swiglu(block.ffn, rms_norm(x, block.ln_ffn)), 0.0
    return x + h, cache, aux


# Matrix products with no batch dimension: ``x @ w`` with a 2-D weight
# reaches the dispatcher as ``mm`` (``addmm`` with a bias); the attention
# einsums are ``bmm`` and are recomputed.
_NO_BATCH_DOTS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: LMConfig):
    """``fn`` under the config's rematerialisation policy where gradients
    are on (the serving path runs ``fn`` as it is)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_dots)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=context)
    if cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r}: need none, full or dots")
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)


def _layer_cache(caches: Dict, i: int) -> Dict:
    return {name: t[i] for name, t in caches.items()}


def forward(params: LM, tokens, cfg: LMConfig, *, positions=None,
            caches: Optional[Dict] = None
            ) -> Tuple[torch.Tensor, Optional[Dict], Any]:
    """tokens: [B, T] -> (logits [B, T, Vp], caches, aux_loss). With
    ``caches`` each layer reads and writes its slice in place; the same
    dict is returned. ``aux_loss`` is the mean of the layers' router losses
    (a 0-dim f32 tensor) for MoE blocks and 0.0 for dense ones."""
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device).expand(B, T)
    x = params.embed[tokens].to(cfg.torch_dtype)
    auxs = []
    for i, block in enumerate(params.blocks):
        if caches is None:
            body = _remat(functools.partial(_block_apply, block,
                                            positions=positions, cfg=cfg,
                                            cache=None), cfg)
            x, _, aux = body(x)
        else:
            x, _, aux = _block_apply(block, x, positions, cfg,
                                     _layer_cache(caches, i))
        auxs.append(aux)
    x = rms_norm(x, params.norm_f)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:   # mask padded vocab rows
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits + torch.where(pad, -1e30, 0.0).to(logits.dtype)
    aux = torch.stack(auxs).mean() if cfg.moe else 0.0
    return logits, caches, aux


def loss_fn(params: LM, batch: Dict, cfg: LMConfig):
    """Next-token cross entropy; batch = {tokens [B, T+1]} or tokens/labels.
    Returns (loss, {"nll", "aux"}), the MoE router loss weighted into the
    loss by ``aux_weight``."""
    if "labels" in batch:
        tokens, labels = batch["tokens"], batch["labels"]
    else:
        tokens, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    logits, _, aux = forward(params, tokens, cfg)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = torch.mean(lse - ll)
    if cfg.moe:
        return nll + cfg.moe.aux_weight * aux, {"nll": nll, "aux": aux}
    return nll, {"nll": nll, "aux": torch.zeros_like(nll)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_caches(cfg: LMConfig, batch: int, max_len: int,
                device="cuda") -> Dict:
    """Stacked caches: k/v [L, B, W or max_len, Hkv, D], pos [L, B],
    window [L]."""
    one = kvc.init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd,
                         cfg.torch_dtype, window=cfg.window,
                         device=resolve_device(device))
    return {name: t[None].repeat((cfg.n_layers,) + (1,) * t.dim())
            for name, t in one.items()}


def prefill(params: LM, tokens, cfg: LMConfig, caches: Dict):
    """Run the prompt through the model, filling the caches. [B, T] tokens.

    Sliding-window models chunk the prompt to the window size (a ring cache
    absorbs at most W tokens per update without overwriting keys that the
    same call's queries still need). Returns the last chunk's logits.
    """
    B, T = tokens.shape
    chunk = cfg.window if cfg.window > 0 else T
    if T <= chunk:
        logits, caches, _ = forward(params, tokens, cfg, caches=caches)
        return logits, caches
    if T % chunk:
        raise ValueError(f"prompt {T} not a multiple of window {chunk}")
    logits = None
    for i in range(T // chunk):
        seg = tokens[:, i * chunk:(i + 1) * chunk]
        pos = torch.arange(i * chunk, (i + 1) * chunk, dtype=torch.int32,
                           device=tokens.device).expand(B, chunk)
        logits, caches, _ = forward(params, seg, cfg, positions=pos,
                                    caches=caches)
    return logits, caches


def decode_step(params: LM, tokens, cfg: LMConfig, caches: Dict):
    """One new token per sequence. tokens: [B, 1] -> (logits [B, Vp],
    caches)."""
    # layer 0's positions [B, 1], copied: the layers advance pos in place
    pos = caches["pos"][0][:, None].clone()
    logits, caches, _ = forward(params, tokens, cfg, positions=pos,
                                caches=caches)
    return logits[:, -1], caches

"""RecSys architectures, serving half: BST, xDeepFM (CIN), BERT4Rec,
two-tower retrieval. Port of the JAX package's ``models/recsys.py``.

One ``nn.Module`` a model, its parameter names the JAX tree's keys
(``item_emb``, ``blocks.0.wq``, ``mlp.w0``, ``cin.0``, ...), so weights
carry across unchanged (``models/convert.py``). Ids follow JAX's gather
rules (``layers.take``: an out-of-range id gives a NaN row) and top-k
follows ``lax.top_k``'s (``moe.top_k``: a stable descending sort, ties to
the lowest index). The JAX ``constrain`` calls are no-ops without a mesh
and are left out. No Pallas kernel lies on this path, in JAX either.

The training losses: ``bce_loss`` (BST, xDeepFM), ``bert4rec_loss`` and
its sampled-softmax form ``bert4rec_sampled_loss``, ``twotower_loss``;
each returns ``(loss, {"nll": loss})``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.stores import resolve_device
from .layers import (MLP, clamped, init_linear, layer_norm, mlp,
                     n_mlp_layers, normal_param, param, take)
from .moe import top_k as _top_k

# Bytes of the CIN's outer product held at once: at xDeepFM's full width
# it is 312,000 B a row (76 GiB at 262,144 rows).
CIN_CHUNK_BYTES = 1 << 31


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, dim: int, dtype, device) -> nn.Parameter:
    return normal_param(gen, (vocab, dim), 0.05, dtype, device)


def embedding_bag(table, idx, *, mode: str = "mean", weights=None):
    """table: [V, D]; idx: [..., bag] int (0 = padding) -> [..., D]."""
    emb = take(table, idx)                                # [..., bag, D]
    m = (idx != 0).to(emb.dtype)[..., None]
    if weights is not None:
        m = m * weights[..., None]
    # in place where the types allow: the gather is ours
    s = torch.sum(emb.mul_(m) if m.dtype == emb.dtype else emb * m, dim=-2)
    if mode == "sum":
        return s
    cnt = torch.clamp_min(torch.sum(m, dim=-2), 1e-9)
    return s / cnt


class Block(nn.Module):
    """A post-embedding transformer block: wq, wk, wv, wo [D, D]; ln1/ln2
    scale and bias [D]; ff1 [D, d_ff], ff2 [d_ff, D]."""

    def __init__(self, D: int, d_ff: int, dtype, device, gen=None):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, init_linear(gen, D, D, dtype, device))
        for ln in ("ln1", "ln2"):
            setattr(self, f"{ln}_s", param(torch.ones(D, dtype=dtype,
                                                      device=device)))
            setattr(self, f"{ln}_b", param(torch.zeros(D, dtype=dtype,
                                                       device=device)))
        self.ff1 = init_linear(gen, D, d_ff, dtype, device)
        self.ff2 = init_linear(gen, d_ff, D, dtype, device)


def _tiny_mha(blk: Block, x, n_heads: int):
    B, T, D = x.shape
    hd = D // n_heads
    q = (x @ blk.wq).reshape(B, T, n_heads, hd)
    k = (x @ blk.wk).reshape(B, T, n_heads, hd)
    v = (x @ blk.wv).reshape(B, T, n_heads, hd)
    logit = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    probs = torch.softmax(logit.div_(math.sqrt(hd)), dim=-1)
    del logit
    o = torch.einsum("bhts,bshd->bthd", probs, v.float())
    return o.reshape(B, T, D).to(x.dtype) @ blk.wo


def _encode(params, x, n_heads: int):
    """Positions added, then the blocks (pre-norm, tanh GELU: ``jax.nn.gelu``
    defaults to the tanh form)."""
    x = x + params.pos_emb[None]
    for blk in params.blocks:
        h = layer_norm(x, blk.ln1_s, blk.ln1_b)
        x = x + _tiny_mha(blk, h, n_heads)
        h = layer_norm(x, blk.ln2_s, blk.ln2_b)
        x = x + F.gelu(h @ blk.ff1, approximate="tanh") @ blk.ff2
    return x


# ---------------------------------------------------------------------------
# BST — Behavior Sequence Transformer (arXiv:1905.06874)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 1_000_000
    n_profile_fields: int = 8
    profile_vocab: int = 100_000
    embed_dim: int = 32
    seq_len: int = 20               # history (seq_len - 1) + target
    n_blocks: int = 1
    n_heads: int = 8
    d_ff: int = 128
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class BST(nn.Module):
    """item_emb [n_items, D], pos_emb [seq_len, D], profile_emb
    [profile_vocab, D], blocks, mlp (to one logit)."""

    def __init__(self, cfg: BSTConfig, device, gen=None):
        super().__init__()
        dt, D = cfg.torch_dtype, cfg.embed_dim
        self.item_emb = init_embedding(gen, cfg.n_items, D, dt, device)
        self.pos_emb = init_embedding(gen, cfg.seq_len, D, dt, device)
        self.profile_emb = init_embedding(gen, cfg.profile_vocab, D, dt,
                                          device)
        self.blocks = nn.ModuleList(Block(D, cfg.d_ff, dt, device, gen)
                                    for _ in range(cfg.n_blocks))
        d_flat = cfg.seq_len * D + cfg.n_profile_fields * D
        self.mlp = MLP((d_flat,) + cfg.mlp_dims + (1,), dt, device, gen)


def bst_init(cfg: BSTConfig, *, generator: torch.Generator,
             device="cuda") -> BST:
    return BST(cfg, resolve_device(device), generator)


def bst_forward(params: BST, batch: Dict, cfg: BSTConfig):
    """batch: {hist [B, seq-1], target [B], profile [B, F]} -> logits [B]."""
    seq = torch.cat([batch["hist"], batch["target"][:, None]], dim=1)
    x = _encode(params, take(params.item_emb, seq), cfg.n_heads)
    prof = take(params.profile_emb, batch["profile"])
    flat = torch.cat([x.reshape(x.shape[0], -1),
                      prof.reshape(prof.shape[0], -1)], dim=1)
    out = mlp(params.mlp, flat, n_mlp_layers(params.mlp), act=F.leaky_relu)
    return out[:, 0]


# ---------------------------------------------------------------------------
# xDeepFM — CIN + DNN + linear (arXiv:1803.05170)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_fields: int = 39
    field_vocab: int = 200_000       # rows per field (single offset table)
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    dnn_dims: Tuple[int, ...] = (400, 400)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def total_vocab(self):
        return self.n_fields * self.field_vocab


class XDeepFM(nn.Module):
    """emb [total_vocab, D], linear_w [total_vocab], cin [Hk * m, Hk+1]
    each, bias [], dnn (to one logit), cin_out [sum(cin_layers), 1]."""

    def __init__(self, cfg: XDeepFMConfig, device, gen=None):
        super().__init__()
        dt, m = cfg.torch_dtype, cfg.n_fields
        self.emb = init_embedding(gen, cfg.total_vocab, cfg.embed_dim, dt,
                                  device)
        self.linear_w = normal_param(gen, (cfg.total_vocab,), 0.01, dt, device)
        h_prev, cin = m, []
        for h in cfg.cin_layers:
            cin.append(init_linear(gen, h_prev * m, h, dt, device))
            h_prev = h
        self.cin = nn.ParameterList(cin)
        self.bias = param(torch.zeros((), dtype=dt, device=device))
        self.dnn = MLP((m * cfg.embed_dim,) + cfg.dnn_dims + (1,), dt,
                       device, gen)
        self.cin_out = init_linear(gen, sum(cfg.cin_layers), 1, dt, device)


def xdeepfm_init(cfg: XDeepFMConfig, *, generator: torch.Generator,
                 device="cuda") -> XDeepFM:
    return XDeepFM(cfg, resolve_device(device), generator)


def _cin(x0, ws):
    """The CIN's pooled features [rows, sum(Hk+1)] of a block of rows.

    Each layer's outer product z = xk[b, h, d] * x0[b, m, d] is held as
    [rows, D, Hk, m], d outermost, so that its product with the layer's
    weight (over z = h * m + m', JAX's reshape order) is one matrix product
    with no transposed copy of z; ``xt`` holds xk as [rows, D, Hk]."""
    B, m, D = x0.shape
    x0t = x0.transpose(1, 2).contiguous()               # [B, D, m]
    xt, pooled = x0t, []
    for w in ws:
        z = xt[..., :, None] * x0t[..., None, :]        # [B, D, Hk, m]
        xt = torch.relu(z.view(B * D, -1) @ w).view(B, D, -1)
        del z
        pooled.append(torch.sum(xt, dim=1))             # [B, Hk+1]
    return torch.cat(pooled, dim=1)


def xdeepfm_forward(params: XDeepFM, batch: Dict, cfg: XDeepFMConfig):
    """batch: {fields [B, n_fields] int (already offset per field)}.

    The CIN runs in blocks of rows, each row with the JAX function's own
    arithmetic (the outer product, then its product with the layer's
    weight), so that no more than ``CIN_CHUNK_BYTES`` of the outer product
    exist at once."""
    ids = batch["fields"]
    x0 = take(params.emb, ids)                           # [B, m, D]
    B, m, D = x0.shape
    lin = torch.sum(take(params.linear_w, ids), dim=1)
    row_bytes = max((m,) + cfg.cin_layers) * m * D * x0.element_size()
    rows = max(1, CIN_CHUNK_BYTES // row_bytes)
    ws = list(params.cin)
    cin_feat = torch.cat([_cin(x0[i:i + rows], ws)
                          for i in range(0, B, rows)]) if B > rows \
        else _cin(x0, ws)
    cin_logit = (cin_feat @ params.cin_out)[:, 0]
    dnn_logit = mlp(params.dnn, x0.reshape(B, -1),
                    n_mlp_layers(params.dnn))[:, 0]
    return lin + cin_logit + dnn_logit + params.bias


# ---------------------------------------------------------------------------
# BERT4Rec — bidirectional masked item prediction (arXiv:1904.06690)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 60_000            # + 1 mask token + 0 pad
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: int = 256
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def mask_id(self):
        return self.n_items + 1

    @property
    def vocab(self):
        return self.n_items + 2


class Bert4Rec(nn.Module):
    """item_emb [vocab, D] (tied output embedding), pos_emb [seq_len, D],
    blocks, out_bias [vocab]."""

    def __init__(self, cfg: Bert4RecConfig, device, gen=None):
        super().__init__()
        dt, D = cfg.torch_dtype, cfg.embed_dim
        self.item_emb = init_embedding(gen, cfg.vocab, D, dt, device)
        self.pos_emb = init_embedding(gen, cfg.seq_len, D, dt, device)
        self.blocks = nn.ModuleList(Block(D, cfg.d_ff, dt, device, gen)
                                    for _ in range(cfg.n_blocks))
        self.out_bias = param(torch.zeros(cfg.vocab, dtype=dt, device=device))


def bert4rec_init(cfg: Bert4RecConfig, *, generator: torch.Generator,
                  device="cuda") -> Bert4Rec:
    return Bert4Rec(cfg, resolve_device(device), generator)


def bert4rec_forward(params: Bert4Rec, batch: Dict, cfg: Bert4RecConfig):
    """batch: {items [B, T]} -> logits [B, T, vocab]."""
    x = _encode(params, take(params.item_emb, batch["items"]), cfg.n_heads)
    return x @ params.item_emb.T + params.out_bias


def bert4rec_sampled_loss(params: Bert4Rec, batch: Dict,
                          cfg: Bert4RecConfig):
    """Sampled-softmax masked-item loss for production vocab sizes.

    batch: {items [B, T], mask_pos [B, M], labels [B, M], neg_ids [K]}.
    The label item competes against K shared negatives (logQ omitted: the
    sampler is uniform in the synthetic pipeline).
    """
    x = _encode(params, take(params.item_emb, batch["items"]), cfg.n_heads)
    pos = batch["mask_pos"].long()
    hm = torch.gather(x, 1, pos[..., None].expand(-1, -1, x.shape[-1]))
    lab_e = take(params.item_emb, batch["labels"])               # [B,M,D]
    neg_e = take(params.item_emb, batch["neg_ids"])              # [K,D]
    V = params.out_bias.shape[0]
    pos_logit = torch.sum(hm * lab_e, dim=-1, dtype=torch.float32) \
        + params.out_bias[clamped(batch["labels"], V)]
    neg_logit = torch.einsum("bmd,kd->bmk", hm.float(), neg_e.float()) \
        + params.out_bias[clamped(batch["neg_ids"], V)][None, None, :]
    lse = torch.logsumexp(torch.cat([pos_logit[..., None], neg_logit],
                                    dim=-1), dim=-1)
    nll = torch.mean(lse - pos_logit)
    return nll, {"nll": nll}


def bert4rec_loss(params: Bert4Rec, batch: Dict, cfg: Bert4RecConfig):
    """Masked-position cross entropy. batch: items, labels, loss_mask."""
    logits = bert4rec_forward(params, batch, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["labels"][..., None].long())[..., 0]
    m = batch["loss_mask"].float()
    nll = torch.sum((lse - ll) * m) / torch.clamp_min(torch.sum(m), 1.0)
    return nll, {"nll": nll}


def bert4rec_topk_serve(params: Bert4Rec, batch: Dict, cfg: Bert4RecConfig,
                        top_k: int = 100, n_chunks: int = 16):
    """Next-item top-k for the last position, hierarchical over vocab
    chunks: the vocabulary padded to a multiple of ``n_chunks`` (padded
    rows score -1e30), the top-k of each chunk, then the top-k of those."""
    x = _encode(params, take(params.item_emb, batch["items"]), cfg.n_heads)
    hl = x[:, -1].float()                                 # [B, D]
    V = cfg.vocab
    pad = (-V) % n_chunks
    scores = hl @ params.item_emb.float().T + params.out_bias
    if pad:   # a zero row's score is its -1e30 bias
        scores = F.pad(scores, (0, pad), value=-1e30)
    Vc = scores.shape[1] // n_chunks
    v1, i1 = _top_k(scores.view(-1, n_chunks, Vc), min(top_k, Vc))
    del scores
    i1 = i1 + torch.arange(n_chunks, device=i1.device)[None, :, None] * Vc
    v2, sel = _top_k(v1.reshape(v1.shape[0], -1), top_k)
    return v2, torch.gather(i1.reshape(i1.shape[0], -1), 1, sel).int()


# ---------------------------------------------------------------------------
# Two-tower retrieval (Yi et al., RecSys'19)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    n_items: int = 10_000_000
    n_users: int = 10_000_000
    hist_len: int = 50
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    logq_correction: bool = True
    temperature: float = 0.05
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class TwoTower(nn.Module):
    """user_emb [n_users, D], item_emb [n_items, D], user_mlp (2D -> ...),
    item_mlp (D -> ...)."""

    def __init__(self, cfg: TwoTowerConfig, device, gen=None):
        super().__init__()
        dt, D = cfg.torch_dtype, cfg.embed_dim
        self.user_emb = init_embedding(gen, cfg.n_users, D, dt, device)
        self.item_emb = init_embedding(gen, cfg.n_items, D, dt, device)
        self.user_mlp = MLP((2 * D,) + cfg.tower_mlp, dt, device, gen)
        self.item_mlp = MLP((D,) + cfg.tower_mlp, dt, device, gen)


def twotower_init(cfg: TwoTowerConfig, *, generator: torch.Generator,
                  device="cuda") -> TwoTower:
    return TwoTower(cfg, resolve_device(device), generator)


def _unit(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), 1e-6)


def user_tower(params: TwoTower, batch: Dict, cfg: TwoTowerConfig):
    u = take(params.user_emb, batch["user_id"])
    h = embedding_bag(params.item_emb, batch["hist"], mode="mean")
    x = torch.cat([u, h], dim=-1)
    return _unit(mlp(params.user_mlp, x, n_mlp_layers(params.user_mlp)))


def item_tower(params: TwoTower, item_ids, cfg: TwoTowerConfig):
    x = take(params.item_emb, item_ids)
    return _unit(mlp(params.item_mlp, x, n_mlp_layers(params.item_mlp)))


def retrieval_scores(params: TwoTower, batch: Dict, cfg: TwoTowerConfig,
                     top_k: int = 100):
    """batch: {user_id [B], hist [B, H], cand_ids [N]} -> the top-k (values,
    indices into cand_ids) of each user's scores over the candidates."""
    u = user_tower(params, batch, cfg)                   # [B, D]
    cand = item_tower(params, batch["cand_ids"], cfg)    # [N, D]
    v, i = _top_k(u @ cand.T, top_k)
    return v, i.int()


def twotower_loss(params: TwoTower, batch: Dict, cfg: TwoTowerConfig):
    """In-batch sampled softmax with logQ correction.

    batch: {user_id [B], hist [B, H], pos_item [B], item_logq [B]}.
    """
    u = user_tower(params, batch, cfg)                   # [B, D]
    v = item_tower(params, batch["pos_item"], cfg)       # [B, D]
    logits = (u @ v.T) / cfg.temperature                 # [B, B]
    if cfg.logq_correction and "item_logq" in batch:
        logits = logits - batch["item_logq"][None, :]
    logits = logits.float()
    labels = torch.arange(u.shape[0], device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None])[:, 0]
    nll = torch.mean(lse - ll)
    return nll, {"nll": nll}


def bce_loss(logits, labels):
    """Binary cross entropy of logits, shared by BST and xDeepFM."""
    z = logits.float()
    y = labels.float()
    nll = torch.mean(torch.clamp_min(z, 0) - z * y
                     + torch.log1p(torch.exp(-torch.abs(z))))
    return nll, {"nll": nll}

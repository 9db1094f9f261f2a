"""Architecture API: port of the JAX package's ``models/api.py`` for the
three families (lm, gnn, recsys).

  * ``ShapeCell`` / ``ArchSpec``      — one (architecture x input shape) cell
  * ``init_params(spec_or_cfg, ...)`` — real parameters from a generator
  * ``abstract_params(cfg)``          — the JAX tree's shapes and dtypes
  * ``loss_fn(cfg)``                  — ``fn(params, batch) -> (loss, metrics)``
  * ``serve_fn(cfg, cell)``            — the step for a prefill, decode,
                                         serve or retrieval cell
  * ``input_specs(cfg, cell)``         — the input tree as ``TensorSpec``s
  * ``make_inputs(rng, cfg, cell)``    — random inputs for a cell
  * ``id_ranges(cfg, cell)``           — the bound of each id input
  * ``sharding_rules`` / ``serve_rules`` / ``batch_axis_for`` — JAX's
                                         sharding tables, as data
  * ``model_bytes`` / ``model_flops``  — the analytic roofline terms
  * ``adapt_lm_config(cfg, cell, dp)`` — MoE dispatch groups for a cell

A GAT has no serving step (``serve_fn`` raises ``TypeError``, as JAX's
does); its forward is ``gnn.forward``. One card has no mesh, so the
sharding tables are data for a caller that places parameters itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.stores import resolve_device
from ..training.optimizer import named_leaves
from . import gnn, recsys, transformer as tr


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) cell of the assignment matrix."""
    name: str
    kind: str                      # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    skip: Optional[str] = None     # reason if inapplicable (recorded, not run)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys
    model: str                     # lm | gat | bst | xdeepfm | bert4rec | twotower
    config: Any
    smoke_config: Any
    shapes: Tuple[ShapeCell, ...]
    source: str = ""

    def cell(self, name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == name:
                return c
        raise KeyError(name)


class TensorSpec(NamedTuple):
    """The shape and dtype of one input (JAX's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# init / params
# ---------------------------------------------------------------------------

_INITS = ((tr.LMConfig, tr.init_params), (gnn.GATConfig, gnn.init_params),
          (recsys.BSTConfig, recsys.bst_init),
          (recsys.XDeepFMConfig, recsys.xdeepfm_init),
          (recsys.Bert4RecConfig, recsys.bert4rec_init),
          (recsys.TwoTowerConfig, recsys.twotower_init))


def init_params(spec_or_cfg, *, generator: torch.Generator, device="cuda"):
    """The model's module with random parameters drawn from ``generator``
    (which must live on ``device``), with the JAX init's distributions."""
    cfg = spec_or_cfg.config if isinstance(spec_or_cfg, ArchSpec) \
        else spec_or_cfg
    for kind, init in _INITS:
        if isinstance(cfg, kind):
            return init(cfg, generator=generator, device=device)
    raise TypeError(type(cfg))


def abstract_params(cfg) -> Dict[str, Any]:
    """The JAX parameter tree's shapes and dtypes (``jax.eval_shape`` of its
    ``init_params``) as ``TensorSpec``s, from the module made on the
    ``meta`` device: dicts by name, lists where JAX has lists, an LM's
    blocks stacked on a leading layer dim."""
    module = init_params(cfg, generator=None, device="meta")
    stacked = getattr(module, "STACKED", None)
    runs: Dict[str, list] = {}
    for path, t in named_leaves(module):
        runs.setdefault(path, []).append(t)
    tree: Dict[str, Any] = {}
    for path, ts in runs.items():
        shape = tuple(ts[0].shape)
        if path.split(".")[0] == stacked:
            shape = (len(ts),) + shape
        *keys, leaf = path.split(".")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = TensorSpec(shape, ts[0].dtype)

    def lists(node):
        if isinstance(node, TensorSpec):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def sharding_rules(cfg):
    """(path regex, logical axes per dim) for training."""
    if isinstance(cfg, tr.LMConfig):
        return tr.params_sharding_rules()
    if isinstance(cfg, gnn.GATConfig):
        return []  # tiny params: fully replicated
    # recsys: embedding tables row-sharded over tp
    return [
        (r"(item_emb|user_emb|profile_emb|emb|linear_w)$", ("tp",)),
        (r"mlp/w0$", (None, "tp")),
        (r"mlp/w1$", ("tp", None)),
    ]


def _param_bytes(cfg) -> int:
    def leaves(node):
        if isinstance(node, TensorSpec):
            yield node
        else:
            for v in (node.values() if isinstance(node, dict) else node):
                yield from leaves(v)
    return int(sum(np.prod(s.shape) * s.dtype.itemsize
                   for s in leaves(abstract_params(cfg))))


def serve_rules(cfg):
    """Param sharding for SERVING: dense LMs keep the 1D training rules,
    MoE LMs shard 2D, small recsys models (< 2 GiB of parameters)
    replicate, and the rest keep the training rules."""
    if isinstance(cfg, tr.LMConfig):
        return tr.serve_sharding_rules() if cfg.moe \
            else tr.params_sharding_rules()
    if isinstance(cfg, gnn.GATConfig):
        return []
    if _param_bytes(cfg) < 2 << 30:
        return []   # fully replicated serving copy
    return sharding_rules(cfg)


def batch_axis_for(cfg, cell: ShapeCell) -> str:
    """The mesh axis a cell's batch shards over: the whole mesh ('all') for
    the small recsys models, which replicate at serve; 'dp' otherwise
    (two-tower's row-sharded item table keeps 'dp')."""
    if isinstance(cfg, (recsys.BSTConfig, recsys.XDeepFMConfig,
                        recsys.Bert4RecConfig)):
        return "all"
    return "dp"


# ---------------------------------------------------------------------------
# loss / serving steps
# ---------------------------------------------------------------------------

def loss_fn(cfg) -> Callable:
    """``fn(params, batch) -> (loss, metrics)`` of a train cell's batch."""
    if isinstance(cfg, tr.LMConfig):
        return lambda p, b: tr.loss_fn(p, b, cfg)
    if isinstance(cfg, gnn.GATConfig):
        return lambda p, b: gnn.loss_fn(p, b, cfg)
    if isinstance(cfg, recsys.BSTConfig):
        return lambda p, b: recsys.bce_loss(recsys.bst_forward(p, b, cfg),
                                            b["labels"])
    if isinstance(cfg, recsys.XDeepFMConfig):
        return lambda p, b: recsys.bce_loss(recsys.xdeepfm_forward(p, b, cfg),
                                            b["labels"])
    if isinstance(cfg, recsys.Bert4RecConfig):
        if cfg.n_items > 100_000:   # production vocab -> sampled softmax
            return lambda p, b: recsys.bert4rec_sampled_loss(p, b, cfg)
        return lambda p, b: recsys.bert4rec_loss(p, b, cfg)
    if isinstance(cfg, recsys.TwoTowerConfig):
        return lambda p, b: recsys.twotower_loss(p, b, cfg)
    raise TypeError(type(cfg))


def serve_fn(cfg, cell: ShapeCell) -> Callable:
    """Forward-only step for serve/prefill/decode/retrieval cells: an LM's
    ``fn(params, caches, tokens) -> (logits, caches)``, a recsys model's
    ``fn(params, batch)``."""
    if isinstance(cfg, tr.LMConfig):
        if cell.kind == "prefill":
            return lambda p, caches, tokens: tr.prefill(p, tokens, cfg, caches)
        if cell.kind == "decode":
            return lambda p, caches, tokens: tr.decode_step(p, tokens, cfg,
                                                            caches)
        raise ValueError(cell.kind)
    if isinstance(cfg, recsys.TwoTowerConfig):
        if cell.kind == "retrieval":
            return lambda p, b: recsys.retrieval_scores(p, b, cfg)
        return lambda p, b: (recsys.user_tower(p, b, cfg) * recsys.item_tower(
            p, b["pos_item"], cfg)).sum(-1)
    if isinstance(cfg, recsys.BSTConfig):
        if cell.kind == "retrieval":
            def bst_retr(p, b):
                n = b["cand_ids"].shape[0]
                bb = {"hist": b["hist"].expand((n,) + b["hist"].shape[1:]),
                      "target": b["cand_ids"],
                      "profile": b["profile"].expand(
                          (n,) + b["profile"].shape[1:])}
                return recsys.bst_forward(p, bb, cfg)
            return bst_retr
        return lambda p, b: recsys.bst_forward(p, b, cfg)
    if isinstance(cfg, recsys.XDeepFMConfig):
        if cell.kind == "retrieval":
            def xd_retr(p, b):
                n = b["cand_ids"].shape[0]
                ctx = b["fields_ctx"].expand(n, cfg.n_fields - 1)
                item = (b["cand_ids"] % cfg.field_vocab
                        + (cfg.n_fields - 1) * cfg.field_vocab)
                fields = torch.cat([ctx, item[:, None].to(ctx.dtype)], dim=1)
                return recsys.xdeepfm_forward(p, {"fields": fields}, cfg)
            return xd_retr
        return lambda p, b: recsys.xdeepfm_forward(p, b, cfg)
    if isinstance(cfg, recsys.Bert4RecConfig):
        if cell.kind == "retrieval" or (cell.kind == "serve"
                                        and cfg.n_items > 100_000):
            return lambda p, b: recsys.bert4rec_topk_serve(p, b, cfg)
        return lambda p, b: recsys.bert4rec_forward(p, b, cfg)
    raise TypeError(type(cfg))


def adapt_lm_config(cfg: tr.LMConfig, cell: ShapeCell, dp_size: int = 1
                    ) -> tr.LMConfig:
    """Per-cell config tweaks: MoE dispatch groups must divide the token
    count and align with the data-parallel axis (one card: ``dp_size``
    1, so one group)."""
    if not isinstance(cfg, tr.LMConfig) or cfg.moe is None:
        return cfg
    d = cell.dims
    n_tok = d["batch"] * d["seq"] if cell.kind in ("train", "prefill") \
        else d["batch"]
    g = dp_size
    while g > 1 and n_tok % g:
        g -= 1
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=g))


# ---------------------------------------------------------------------------
# input specs + materialization
# ---------------------------------------------------------------------------

def input_specs(cfg, cell: ShapeCell) -> Dict[str, Any]:
    """The input tree of a cell, each leaf a ``TensorSpec`` (no
    allocation)."""
    S, i32, d = TensorSpec, torch.int32, cell.dims

    if isinstance(cfg, tr.LMConfig):
        if cell.kind == "train":
            return {"batch": {"tokens": S((d["batch"], d["seq"] + 1), i32)}}
        caches = tr.init_caches(cfg, d["batch"], d.get("cache_len", d["seq"]),
                                device="meta")
        caches = {k: S(tuple(t.shape), t.dtype) for k, t in caches.items()}
        T = d["seq"] if cell.kind == "prefill" else 1
        return {"caches": caches, "tokens": S((d["batch"], T), i32)}

    if isinstance(cfg, gnn.GATConfig):
        n = d["n_nodes"]
        e = d.get("n_edges_padded", d["n_edges"])
        return {"batch": {"x": S((n, d["d_feat"]), torch.float32),
                          "src": S((e,), i32), "dst": S((e,), i32),
                          "labels": S((n,), i32),
                          "label_mask": S((n,), torch.bool),
                          "edge_valid": S((e,), torch.bool)}}

    B = d.get("batch", 1)
    if isinstance(cfg, recsys.BSTConfig):
        if cell.kind == "retrieval":
            return {"batch": {
                "hist": S((1, cfg.seq_len - 1), i32),
                "profile": S((1, cfg.n_profile_fields), i32),
                "cand_ids": S((d["n_candidates"],), i32)}}
        b = {"hist": S((B, cfg.seq_len - 1), i32), "target": S((B,), i32),
             "profile": S((B, cfg.n_profile_fields), i32)}
        if cell.kind == "train":
            b["labels"] = S((B,), i32)
        return {"batch": b}
    if isinstance(cfg, recsys.XDeepFMConfig):
        if cell.kind == "retrieval":
            return {"batch": {
                "fields_ctx": S((1, cfg.n_fields - 1), i32),
                "cand_ids": S((d["n_candidates"],), i32)}}
        b = {"fields": S((B, cfg.n_fields), i32)}
        if cell.kind == "train":
            b["labels"] = S((B,), i32)
        return {"batch": b}
    if isinstance(cfg, recsys.Bert4RecConfig):
        b = {"items": S((B, cfg.seq_len), i32)}
        if cell.kind == "train":
            if cfg.n_items > 100_000:   # sampled softmax inputs
                M = max(1, int(0.15 * cfg.seq_len))
                b["mask_pos"] = S((B, M), i32)
                b["labels"] = S((B, M), i32)
                b["neg_ids"] = S((8192,), i32)
            else:
                b["labels"] = S((B, cfg.seq_len), i32)
                b["loss_mask"] = S((B, cfg.seq_len), torch.bool)
        return {"batch": b}
    if isinstance(cfg, recsys.TwoTowerConfig):
        b = {"user_id": S((B,), i32), "hist": S((B, cfg.hist_len), i32)}
        if cell.kind == "train":
            b["pos_item"] = S((B,), i32)
            b["item_logq"] = S((B,), torch.float32)
        elif cell.kind == "retrieval":
            b["cand_ids"] = S((d["n_candidates"],), i32)
        else:
            b["pos_item"] = S((B,), i32)
        return {"batch": b}
    raise TypeError(type(cfg))


def _fill(rng: np.random.Generator, tree):
    """Draw every leaf as JAX's ``make_inputs`` does, in ``jax.tree.map``'s
    order (a dict's keys sorted): int32 below 100, bool at 1/2, floats
    standard normal."""
    if isinstance(tree, TensorSpec):
        if tree.dtype == torch.int32:
            return rng.integers(0, 100, tree.shape)
        if tree.dtype == torch.bool:
            return rng.random(tree.shape) < 0.5
        return rng.standard_normal(tree.shape).astype(np.float32)
    return {k: _fill(rng, tree[k]) for k in sorted(tree)}


def id_ranges(cfg, cell: ShapeCell) -> Dict[str, int]:
    """Each id input of a GNN or recsys cell and the bound its ids stay
    below (``fields`` and ``fields_ctx``: within a field, before the
    field's offset of ``field * field_vocab``)."""
    if isinstance(cfg, gnn.GATConfig):
        n = cell.dims["n_nodes"]
        return {"src": n, "dst": n, "labels": cfg.n_classes}
    if isinstance(cfg, recsys.BSTConfig):
        return {"hist": cfg.n_items, "target": cfg.n_items,
                "cand_ids": cfg.n_items, "profile": cfg.profile_vocab,
                "labels": 2}
    if isinstance(cfg, recsys.XDeepFMConfig):
        return {"fields": cfg.field_vocab, "fields_ctx": cfg.field_vocab,
                "cand_ids": cfg.total_vocab, "labels": 2}
    if isinstance(cfg, recsys.Bert4RecConfig):
        return {"items": cfg.vocab, "labels": cfg.vocab,
                "mask_pos": cfg.seq_len, "neg_ids": cfg.vocab}
    if isinstance(cfg, recsys.TwoTowerConfig):
        return {"user_id": cfg.n_users, "hist": cfg.n_items,
                "pos_item": cfg.n_items, "cand_ids": cfg.n_items}
    raise TypeError(type(cfg))


def _host_inputs(rng: np.random.Generator, cfg, cell: ShapeCell) -> Dict:
    """The numpy batch of a GNN or recsys cell, ids brought into range as
    JAX's ``make_inputs`` brings them (``% bound``, then a field's
    offset)."""
    b = _fill(rng, input_specs(cfg, cell))["batch"]
    for k, hi in id_ranges(cfg, cell).items():
        if k in b:
            b[k] = b[k] % hi
    for k in ("fields", "fields_ctx"):
        if k in b:
            b[k] = b[k] + np.arange(b[k].shape[1])[None] * cfg.field_vocab
    return {k: v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in b.items()}


def make_inputs(rng: np.random.Generator, cfg, cell: ShapeCell,
                device="cuda") -> Dict:
    """Random inputs of a cell on ``device``.

    GNN and recsys cells (train cells' labels too) and LM train cells
    ([B, seq + 1] tokens): ``{"batch": {...}}``, array for array JAX's
    ``make_inputs`` from the same generator state. LM prefill ([B, seq] tokens) and decode ([B, 1]) cells: ``{"caches",
    "tokens"}``, token ids drawn as JAX draws them (integers below 100, mod
    the vocabulary) with fresh caches of ``cache_len`` (default ``seq``);
    the JAX function also draws values for the caches it then discards,
    so these ids are not draw-for-draw its."""
    device = resolve_device(device)
    if isinstance(cfg, tr.LMConfig):
        d = cell.dims
        if cell.kind == "train":
            tokens = rng.integers(0, 100, (d["batch"], d["seq"] + 1)) \
                % cfg.vocab_size
            return {"batch": {"tokens": torch.from_numpy(
                tokens.astype(np.int32)).to(device)}}
        shape = (d["batch"], d["seq"] if cell.kind == "prefill" else 1)
        tokens = rng.integers(0, 100, shape) % cfg.vocab_size
        return {"caches": tr.init_caches(cfg, d["batch"],
                                         d.get("cache_len", d["seq"]),
                                         device),
                "tokens": torch.from_numpy(tokens.astype(np.int32)).to(
                    device)}
    return {"batch": {k: torch.from_numpy(v).to(device)
                      for k, v in _host_inputs(rng, cfg, cell).items()}}


# ---------------------------------------------------------------------------
# MODEL_BYTES — analytic HBM-traffic model for the roofline memory term
# (a copy of the JAX package's; bf16 = 2 B, f32 = 4 B):
#
#  LM train:  36*P (params fwd+bwd reads, f32 grads, master/m/v R+W)
#             + L*T*(28*d + 24*ff_eff)*2  (residual save + remat recompute
#               + bwd intermediate traffic; ff_eff folds MoE top-k+shared)
#             + 6*T*Vpad*2  (logits write + bwd read + grad)
#  LM prefill: 2*P + L*T*(15*d + 9*ff_eff)*2 + KV writes
#  LM decode:  2*P (weights stream once per token)  + KV cache read/write
#  GNN:        per layer: edge gather+scatter of [E,H,D] messages (x3 lanes)
#              + node features; train = 3x fwd
#  recsys:     embedding gathers + widest interaction tensors + MLP acts
# ---------------------------------------------------------------------------

def model_bytes(cfg, cell: ShapeCell) -> float:
    d_ = cell.dims
    if isinstance(cfg, tr.LMConfig):
        P = cfg.param_count()
        d = cfg.d_model
        if cfg.moe:
            ff_eff = (cfg.moe.top_k * cfg.moe.d_ff * 1.5
                      + cfg.moe.n_shared_experts * cfg.moe.shared_d_ff)
        else:
            ff_eff = cfg.d_ff
        if cell.kind == "train":
            T = d_["batch"] * d_["seq"]
            act = cfg.n_layers * T * (28 * d + 24 * ff_eff) * 2.0
            logits = 6.0 * T * cfg.padded_vocab * 2.0
            return 36.0 * P + act + logits
        if cell.kind == "prefill":
            T = d_["batch"] * d_["seq"]
            act = cfg.n_layers * T * (15 * d + 9 * ff_eff) * 2.0
            kv = cfg.n_layers * T * 2 * cfg.n_kv_heads * cfg.hd * 2.0
            return 2.0 * P + act + kv
        # decode: one token/seq; weights stream once, KV cache read+write
        B = d_["batch"]
        ctx = min(d_.get("cache_len", d_["seq"]),
                  cfg.window if cfg.window > 0 else d_["seq"])
        kv = cfg.n_layers * B * ctx * 2 * cfg.n_kv_heads * cfg.hd * 2.0
        act = cfg.n_layers * B * (15 * d + 9 * ff_eff) * 2.0
        return 2.0 * P + kv + act
    if isinstance(cfg, gnn.GATConfig):
        E, N = d_["n_edges"], d_["n_nodes"]
        msg = cfg.n_layers * 3.0 * E * cfg.n_heads * cfg.d_hidden * 4.0
        nodes = 2.0 * N * d_["d_feat"] * 4.0
        f = msg + nodes
        return 3.0 * f if cell.kind == "train" else f
    B = d_.get("batch", 1)
    if isinstance(cfg, recsys.TwoTowerConfig):
        emb = 2.0 * B * (cfg.hist_len + 1) * cfg.embed_dim * 4.0
        mlp_t = 2.0 * B * sum(cfg.tower_mlp) * 4.0 * 2
        f = emb + mlp_t
        if cell.kind == "retrieval":
            n = d_["n_candidates"]
            f += 2.0 * n * (cfg.embed_dim + sum(cfg.tower_mlp)) * 4.0
            f += 2.0 * B * n * 4.0
        if cell.kind == "train":
            f = 3.0 * f + 2.0 * B * B * 4.0
        return f
    if isinstance(cfg, recsys.XDeepFMConfig):
        m, D = cfg.n_fields, cfg.embed_dim
        emb = 2.0 * B * m * D * 4.0
        z = sum(2.0 * B * h * m * D * 4.0 for h in cfg.cin_layers)
        dnn = 2.0 * B * sum(cfg.dnn_dims) * 4.0
        f = emb + z + dnn
        return 3.0 * f if cell.kind == "train" else f
    if isinstance(cfg, recsys.BSTConfig):
        T, D = cfg.seq_len, cfg.embed_dim
        act = 2.0 * B * (T * D * 10 + sum(cfg.mlp_dims)) * 4.0
        return 3.0 * act if cell.kind == "train" else act
    if isinstance(cfg, recsys.Bert4RecConfig):
        T, D = cfg.seq_len, cfg.embed_dim
        act = 2.0 * B * T * D * 10 * cfg.n_blocks * 4.0
        if cell.kind == "train" and cfg.n_items > 100_000:
            act += 2.0 * B * int(0.15 * T) * 8192 * 4.0   # sampled logits
            act *= 3.0
        elif cell.kind == "train":
            act = 3.0 * (act + 2.0 * B * T * cfg.vocab * 4.0)
        else:
            act += 2.0 * B * cfg.vocab * 4.0               # top-k scores
        return act
    raise TypeError(type(cfg))


# ---------------------------------------------------------------------------
# MODEL_FLOPS (the "useful compute" numerator of the roofline)
# ---------------------------------------------------------------------------

def _mlp_flops(dims) -> float:
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def model_flops(cfg, cell: ShapeCell) -> float:
    d = cell.dims
    if isinstance(cfg, tr.LMConfig):
        n = cfg.active_param_count() if cfg.moe else cfg.param_count()
        if cell.kind == "train":
            return 6.0 * n * d["batch"] * d["seq"]
        if cell.kind == "prefill":
            return 2.0 * n * d["batch"] * d["seq"]
        return 2.0 * n * d["batch"]  # decode: one token per sequence
    if isinstance(cfg, gnn.GATConfig):
        # per edge per layer: attention score + message (2 * H * D flops-ish)
        e = d["n_edges"]
        n = d["n_nodes"]
        h, dd = cfg.n_heads, cfg.d_hidden
        proj = 2.0 * n * cfg.d_in * h * dd
        msg = 6.0 * e * h * dd
        f = cfg.n_layers * (proj + msg)
        return 3.0 * f if cell.kind == "train" else f
    # recsys: dominated by MLP/interaction + embedding gathers
    B = d.get("batch", 1)
    if isinstance(cfg, recsys.TwoTowerConfig):
        fl = _mlp_flops((2 * cfg.embed_dim,) + cfg.tower_mlp)
        fl += _mlp_flops((cfg.embed_dim,) + cfg.tower_mlp)
        f = B * fl
        if cell.kind == "retrieval":
            f += 2.0 * B * d["n_candidates"] * cfg.tower_mlp[-1]
            f += d["n_candidates"] * _mlp_flops((cfg.embed_dim,)
                                                + cfg.tower_mlp)
        if cell.kind == "train":
            f = 3.0 * f + 2.0 * B * B * cfg.tower_mlp[-1]
        return f
    if isinstance(cfg, recsys.XDeepFMConfig):
        if cell.kind == "retrieval":
            B = d["n_candidates"]   # broadcast-forward over candidates
        m, D = cfg.n_fields, cfg.embed_dim
        h_prev, cin = m, 0.0
        for h in cfg.cin_layers:
            cin += 2.0 * h_prev * m * D * h
            h_prev = h
        dnn = _mlp_flops((m * D,) + cfg.dnn_dims + (1,))
        f = B * (cin + dnn)
        return 3.0 * f if cell.kind == "train" else f
    if isinstance(cfg, recsys.BSTConfig):
        if cell.kind == "retrieval":
            B = d["n_candidates"]
        T, D = cfg.seq_len, cfg.embed_dim
        attn = cfg.n_blocks * (8.0 * T * D * D + 4.0 * T * T * D
                               + 4.0 * T * D * cfg.d_ff)
        head = _mlp_flops((T * D + cfg.n_profile_fields * D,)
                          + cfg.mlp_dims + (1,))
        f = B * (attn + head)
        return 3.0 * f if cell.kind == "train" else f
    if isinstance(cfg, recsys.Bert4RecConfig):
        T, D = cfg.seq_len, cfg.embed_dim
        enc = cfg.n_blocks * (8.0 * T * D * D + 4.0 * T * T * D
                              + 4.0 * T * D * cfg.d_ff)
        if cell.kind == "train":
            if cfg.n_items > 100_000:   # sampled softmax over K+1 candidates
                M = max(1, int(0.15 * T))
                out = 2.0 * M * D * (8192 + 1)
            else:
                out = 2.0 * T * D * cfg.vocab
            return 3.0 * B * (enc + out)
        # serve/retrieval: encoder + LAST-position scores over the vocab
        out = 2.0 * D * cfg.vocab
        return B * (enc + out)
    raise TypeError(type(cfg))

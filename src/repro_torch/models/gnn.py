"""GAT (Velickovic et al., arXiv:1710.10903) with segment-op message
passing. Port of the JAX package's ``models/gnn.py``.

Message passing is a gather over the edge index, an edge softmax by
segment max and segment sum, and a scatter-sum of the messages, with JAX's
rules: a gather clamps an id into range (``layers.clamped``), a segment op
drops an edge whose segment is out of range, an empty segment's max is
-inf and then 0. The segment sums are ``index_add_``, which sums with
float atomics on CUDA, so two runs there may differ in the last bits. The
JAX ``constrain`` calls are no-ops without a mesh and are left out.

Includes the host-side fanout neighbour sampler of the ``minibatch_lg``
shape, a numpy copy of JAX's that gives the same arrays from the same
``np.random.Generator``, and the training loss (:func:`loss_fn`).

Gradients: the segment max shifts the softmax, whose value does not depend
on the shift, so its gradient sums to zero over a segment. Where two edges
tie for a segment's max, ``scatter_reduce("amax")`` shares that zero sum
between them as JAX's scatter-max does not; each edge's gradient then
differs from JAX's by rounding only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.stores import resolve_device
from .layers import clamped, init_linear, normal_param


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    d_in: int
    d_hidden: int           # per head
    n_heads: int
    n_layers: int
    n_classes: int
    dtype: str = "float32"
    negative_slope: float = 0.2

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _heads_out(cfg: GATConfig, l: int):
    last = l == cfg.n_layers - 1
    return last, (1 if last else cfg.n_heads), \
        (cfg.n_classes if last else cfg.d_hidden)


class GATLayer(nn.Module):
    """w [d_in, heads * d_out]; a_src, a_dst [heads, d_out]."""

    def __init__(self, d_in: int, heads: int, d_out: int, dtype, device,
                 gen=None):
        super().__init__()
        self.w = init_linear(gen, d_in, heads * d_out, dtype, device)
        self.a_src = normal_param(gen, (heads, d_out), 0.1, dtype, device)
        self.a_dst = normal_param(gen, (heads, d_out), 0.1, dtype, device)


class GAT(nn.Module):
    """layers: one ``GATLayer`` a layer (the last: one head, n_classes)."""

    def __init__(self, cfg: GATConfig, device, gen=None):
        super().__init__()
        layers, d_in = [], cfg.d_in
        for l in range(cfg.n_layers):
            last, heads, d_out = _heads_out(cfg, l)
            layers.append(GATLayer(d_in, heads, d_out, cfg.torch_dtype,
                                   device, gen))
            d_in = d_out if last else heads * d_out
        self.layers = nn.ModuleList(layers)


def init_params(cfg: GATConfig, *, generator: torch.Generator,
                device="cuda") -> GAT:
    """Random parameters with the JAX ``init_params`` distributions (w
    N(0, 1/d_in), a_src and a_dst N(0, 0.01)); the numbers differ from
    JAX's."""
    return GAT(cfg, resolve_device(device), generator)


def _segments(seg, n: int):
    """Segment ids with every id outside [0, n) sent to a spare segment n,
    which the caller drops (JAX's segment ops drop them)."""
    seg = seg.long()
    return torch.where((seg >= 0) & (seg < n), seg, n)


def segment_max(data, seg, n: int):
    """``jax.ops.segment_max``: -inf where a segment is empty."""
    out = torch.full((n + 1,) + data.shape[1:], float("-inf"),
                     dtype=data.dtype, device=data.device)
    idx = _segments(seg, n).view((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce_(0, idx.expand_as(data), data, "amax")[:n]


def segment_sum(data, seg, n: int):
    """``jax.ops.segment_sum``: 0 where a segment is empty."""
    out = torch.zeros((n + 1,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, _segments(seg, n), data)[:n]


def gat_layer(p: GATLayer, x, src, dst, n_nodes: int, heads: int,
              d_out: int, edge_valid=None, slope: float = 0.2,
              last: bool = False):
    """x: [N, d_in]; src/dst: [E] int (message src -> dst)."""
    h = (x @ p.w).reshape(-1, heads, d_out)               # [N, H, D]
    e_src = torch.sum(h * p.a_src[None], dim=-1)          # [N, H]
    e_dst = torch.sum(h * p.a_dst[None], dim=-1)
    src_at = clamped(src, h.shape[0])
    # per-edge unnormalized attention
    logits = F.leaky_relu(e_src[src_at] + e_dst[clamped(dst, h.shape[0])],
                          slope)                          # [E, H]
    if edge_valid is not None:
        logits = torch.where(edge_valid[:, None], logits, -1e30)
        safe_dst = torch.where(edge_valid, dst, n_nodes - 1)
    else:
        safe_dst = dst
    dst_at = clamped(safe_dst, n_nodes)
    # segment softmax over incoming edges of each dst (f32, max-shifted)
    logits = logits.float()
    lmax = segment_max(logits, safe_dst, n_nodes)         # [N, H]
    lmax = torch.where(torch.isfinite(lmax), lmax, 0.0)
    ex = torch.exp(logits - lmax[dst_at])
    del logits
    if edge_valid is not None:
        ex = torch.where(edge_valid[:, None], ex, 0.0)
    denom = segment_sum(ex, safe_dst, n_nodes)
    alpha = ex / torch.clamp_min(denom[dst_at], 1e-16)    # [E, H]
    del ex
    msg = h[src_at].float().mul_(alpha[..., None])      # [E, H, D]
    del alpha
    out = segment_sum(msg, safe_dst, n_nodes)             # [N, H, D]
    if last:
        out = torch.mean(out, dim=1)                      # average heads
    else:
        out = F.elu(out.reshape(n_nodes, heads * d_out))
    return out.to(x.dtype)


def forward(params: GAT, batch: Dict, cfg: GATConfig):
    """batch: {x [N, F], src [E], dst [E], edge_valid? [E]} -> logits
    [N, C]."""
    x = batch["x"].to(cfg.torch_dtype)
    src, dst = batch["src"], batch["dst"]
    ev = batch.get("edge_valid")
    n = x.shape[0]
    for l, p in enumerate(params.layers):
        last, heads, d_out = _heads_out(cfg, l)
        x = gat_layer(p, x, src, dst, n, heads, d_out, ev,
                      cfg.negative_slope, last)
    return x


def loss_fn(params: GAT, batch: Dict, cfg: GATConfig):
    """Masked node-classification cross entropy: (loss, {"nll": loss})."""
    logits = forward(params, batch, cfg).float()
    labels = batch["labels"]
    mask = batch.get("label_mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.bool)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    nll = torch.sum(torch.where(mask, lse - ll, 0.0)) / torch.clamp_min(
        torch.sum(mask.float()), 1.0)
    return nll, {"nll": nll}


# ---------------------------------------------------------------------------
# Neighbour sampler (host-side, GraphSAGE-style fanout sampling)
# ---------------------------------------------------------------------------

class CSRGraph(NamedTuple):
    indptr: np.ndarray   # [N+1]
    indices: np.ndarray  # [E] — in-neighbors of each node


def build_csr(n_nodes: int, src: np.ndarray, dst: np.ndarray) -> CSRGraph:
    """CSR over incoming edges (dst -> its srcs)."""
    order = np.argsort(dst, kind="stable")
    s_dst = dst[order]
    s_src = src[order]
    counts = np.bincount(s_dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=s_src.astype(np.int64))


def sample_subgraph(g: CSRGraph, feats: np.ndarray, seed_nodes: np.ndarray,
                    fanouts: List[int], rng: np.random.Generator
                    ) -> Dict[str, np.ndarray]:
    """Layered fanout sampling; returns padded static-shape arrays.

    Output nodes are renumbered 0..N_sub; seeds occupy [0, len(seeds)).
    Shapes: nodes = seeds * prod(1 + fanouts...) upper bound; edges padded
    with edge_valid mask.
    """
    n_seeds = len(seed_nodes)
    max_nodes = n_seeds
    layer_sizes = [n_seeds]
    for f in fanouts:
        layer_sizes.append(layer_sizes[-1] * f)
        max_nodes += layer_sizes[-1]
    max_edges = sum(layer_sizes[1:])

    node_ids = list(seed_nodes)
    node_pos = {int(n): i for i, n in enumerate(seed_nodes)}
    src_l, dst_l = [], []
    frontier = list(seed_nodes)
    for f in fanouts:
        nxt = []
        for n in frontier:
            lo, hi = g.indptr[n], g.indptr[n + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, int(deg))
            picks = g.indices[lo + rng.choice(deg, size=take, replace=False)]
            for p in picks:
                p = int(p)
                if p not in node_pos:
                    node_pos[p] = len(node_ids)
                    node_ids.append(p)
                src_l.append(node_pos[p])
                dst_l.append(node_pos[int(n)])
                nxt.append(p)
        frontier = nxt

    n_sub = len(node_ids)
    x = np.zeros((max_nodes, feats.shape[1]), feats.dtype)
    x[:n_sub] = feats[np.asarray(node_ids, np.int64)]
    E = len(src_l)
    src = np.full(max_edges, max_nodes - 1, np.int32)
    dst = np.full(max_edges, max_nodes - 1, np.int32)
    src[:E] = src_l
    dst[:E] = dst_l
    ev = np.zeros(max_edges, bool)
    ev[:E] = True
    return {"x": x, "src": src, "dst": dst, "edge_valid": ev,
            "node_ids": np.asarray(node_ids[:n_sub], np.int64),
            "n_sub": n_sub, "n_seeds": n_seeds}

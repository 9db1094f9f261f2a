"""Mixture-of-Experts FFN: top-k routing, capacity-bounded sort dispatch,
optional shared experts (Qwen-MoE style), Switch-style aux loss. Port of
the JAX package's ``models/moe.py``.

Dispatch is group-local: tokens are reshaped to (G, N/G, d) and routing,
the sort and the scatter happen within a group, with an (E, C, d) buffer
per group; C = ceil(top_k * N_g / E * capacity_factor), padded to a
multiple of 8. Overflowed assignments fall through with zero update (the
standard capacity drop).

The JAX module's ``constrain`` calls place the dispatch buffers on a mesh;
one card has no mesh, so they are left out. The three batched expert
products are ``torch.bmm``: JAX computes them as einsums outside any
Pallas kernel.

Every step is deterministic on CUDA: top-k is a stable descending sort
(ties go to the lowest expert, as ``lax.top_k`` breaks them), the sort by
expert is stable, the slot tables are written at unique indices, and the
combine gathers each token's k slot rows and adds them in ascending slot
order, each contribution rounded to the activation dtype first, as JAX's
scatter-add rounds it. No float value goes through an atomic add.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.stores import resolve_device
from .layers import init_linear, normal_param


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert ffn width
    n_shared_experts: int = 0      # Qwen-style always-on experts
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_weight: float = 0.01       # router loss weight in transformer.loss_fn
    groups: int = 1                # dispatch groups


class SharedExperts(nn.Module):
    """w_gate, w_up [d, SF]; w_down [SF, d]; gate [d, 1], with
    SF = shared_d_ff * n_shared_experts."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype, device,
                 gen=None):
        super().__init__()
        sf = cfg.shared_d_ff * cfg.n_shared_experts
        for name, (d_in, d_out) in {"w_gate": (d_model, sf),
                                    "w_up": (d_model, sf),
                                    "w_down": (sf, d_model),
                                    "gate": (d_model, 1)}.items():
            setattr(self, name, init_linear(gen, d_in, d_out, dtype, device))


class MoE(nn.Module):
    """router [d, E] in f32; w_gate, w_up [E, d, F] and w_down [E, F, d] in
    the config dtype; ``shared`` with shared experts."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype, device,
                 gen=None):
        super().__init__()
        E, F_ = cfg.n_experts, cfg.d_ff
        s = 1.0 / math.sqrt(d_model)
        self.router = init_linear(gen, d_model, E, torch.float32, device)
        self.w_gate = normal_param(gen, (E, d_model, F_), s, dtype, device)
        self.w_up = normal_param(gen, (E, d_model, F_), s, dtype, device)
        self.w_down = normal_param(gen, (E, F_, d_model),
                                   1.0 / math.sqrt(F_), dtype, device)
        if cfg.n_shared_experts > 0:
            self.shared = SharedExperts(d_model, cfg, dtype, device, gen)


def init_moe(d_model: int, cfg: MoEConfig, dtype, *,
             generator: torch.Generator, device="cuda") -> MoE:
    """Random parameters with the JAX ``init_moe`` distributions. The
    numbers differ from JAX's; ``generator`` must live on ``device``."""
    return MoE(d_model, cfg, dtype, resolve_device(device), generator)


def capacity(cfg: MoEConfig, n_group: int) -> int:
    """Slots per expert and group, padded to a multiple of 8."""
    c = int(math.ceil(cfg.top_k * n_group / cfg.n_experts
                      * cfg.capacity_factor))
    return c + (-c) % 8


class Route(NamedTuple):
    """One layer's dispatch. ``slot_tok`` [G, E*C]: the token in each slot,
    -1 where empty; ``slot_gate`` [G, E*C]; ``token_slot`` [G, Ng, k]: each
    token's slots in ascending order, ``E*C`` for a dropped assignment;
    ``n_kept`` and ``n_dropped``: assignments over all groups (0-dim)."""
    C: int
    aux: torch.Tensor
    slot_tok: torch.Tensor
    slot_gate: torch.Tensor
    token_slot: torch.Tensor
    n_kept: torch.Tensor
    n_dropped: torch.Tensor


def top_k(logits, k: int):
    """The k largest of the last dim, ties to the lowest index
    (``lax.top_k``'s rule; ``torch.topk`` promises no tie order)."""
    v, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(router_logits, cfg: MoEConfig) -> Route:
    """router_logits: (G, Ng, E) f32 -> the dispatch (JAX ``moe.py:71-105``)."""
    G, Ng, E = router_logits.shape
    k = cfg.top_k
    C = capacity(cfg, Ng)
    dev = router_logits.device

    top_v, top_i = top_k(router_logits, k)                  # (G, Ng, k)
    gates = torch.softmax(top_v, dim=-1)
    probs = torch.softmax(router_logits, dim=-1)
    me = probs.mean(dim=1)                                   # (G, E)
    flat_e = top_i.reshape(G, Ng * k)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))  # integers: exact
    ce = counts.float() / (Ng * k)
    aux = torch.mean(E * torch.sum(me * ce, dim=-1))

    flat_t = torch.arange(Ng, device=dev).repeat_interleave(k).expand(G, -1)
    flat_g = gates.reshape(G, Ng * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)      # per group
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sg = torch.gather(flat_g, 1, order)
    # segment_min of the sorted index per expert = exclusive cumsum of counts
    seg_start = torch.cumsum(counts, dim=1) - counts
    idx = torch.arange(Ng * k, device=dev).expand(G, -1)
    pos = idx - torch.gather(seg_start, 1, se)
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)           # E*C: dropped

    # kept slots are unique; every dropped assignment lands in column E*C,
    # which is cut off
    slot_tok = torch.full((G, E * C + 1), -1, dtype=torch.int64, device=dev)
    slot_tok.scatter_(1, slot, st)
    slot_gate = torch.zeros((G, E * C + 1), dtype=torch.float32, device=dev)
    slot_gate.scatter_(1, slot, sg)
    # each assignment's slot back in token order, then sorted per token
    token_slot = torch.empty_like(slot).scatter_(1, order, slot)
    token_slot = torch.sort(token_slot.view(G, Ng, k), dim=-1).values
    n_kept = keep.sum()
    return Route(C, aux, slot_tok[:, :E * C], slot_gate[:, :E * C],
                 token_slot, n_kept, keep.numel() - n_kept)


def _dispatch_all_groups(xf, router_logits, cfg: MoEConfig,
                         w_gate, w_up, w_down):
    """xf: (G, Ng, d); router_logits: (G, Ng, E) f32 -> (out, aux)."""
    G, Ng, d = xf.shape
    E = cfg.n_experts
    r = route(router_logits, cfg)
    C = r.C
    valid = r.slot_tok >= 0
    h_in = torch.gather(xf, 1, r.slot_tok.clamp_min(0)[..., None]
                        .expand(G, E * C, d))
    h_in = torch.where(valid[..., None], h_in, 0)           # (G, E*C, d)
    # (G, E, C, d) -> (E, G*C, d): one batched product per weight
    h_in = h_in.view(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(h_in, w_gate)) * torch.bmm(h_in, w_up)
    out_e = torch.bmm(h, w_down)                            # (E, G*C, d)
    out_e = out_e.view(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # combine: each token's k contributions (out_e * gate in f32, rounded to
    # x's dtype), dropped ones zero, added in ascending slot order
    zero = out_e.new_zeros((G, 1, d))
    rows = torch.cat([out_e, zero], dim=1)                  # slot E*C: zero
    gate = torch.cat([r.slot_gate, r.slot_gate.new_zeros((G, 1))], dim=1)
    ts = r.token_slot.view(G, Ng * cfg.top_k)
    contrib = torch.gather(rows, 1, ts[..., None].expand(-1, -1, d))
    contrib = (contrib * torch.gather(gate, 1, ts)[..., None]).to(xf.dtype)
    contrib = contrib.view(G, Ng, cfg.top_k, d)
    out = contrib[:, :, 0]
    for j in range(1, cfg.top_k):
        out = out + contrib[:, :, j]
    return out, r.aux


def moe_ffn(params: MoE, x, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss). Group-local dispatch."""
    B, T, d = x.shape
    N = B * T
    G = cfg.groups
    if N % G:
        raise ValueError(f"tokens {N} not divisible by groups {G}")
    xf = x.reshape(G, N // G, d)
    logits = xf.float() @ params.router                     # (G, Ng, E)
    out, aux = _dispatch_all_groups(xf, logits, cfg, params.w_gate,
                                    params.w_up, params.w_down)
    out = out.reshape(B, T, d)
    shared: Optional[SharedExperts] = getattr(params, "shared", None)
    if shared is not None:
        h = F.silu(x @ shared.w_gate) * (x @ shared.w_up)
        out = out + torch.sigmoid(x @ shared.gate) * (h @ shared.w_down)
    return out, aux

"""AdamW + LR schedules + global-norm clipping. Port of the JAX package's
``training/optimizer.py``.

Mixed precision: moments are f32; with ``master_weights`` the fp32 master
copy lives in the optimizer state and model params are the cast-down view
(standard bf16 training setup).

The JAX functions take parameter pytrees; here ``params`` is a model's
``nn.Module`` (or a dict of tensors), and gradients and the state's ``m``,
``v`` and ``master`` are lists in :func:`named_leaves` order: JAX's leaf
order, with each leaf of an LM's stacked ``blocks`` given as its layers'
tensors in layer order. ``apply_updates`` writes the new values into the
parameters and moments in place. The schedule, the clip scale and the bias
corrections are f32 tensors computed as JAX computes them (``b1 **
step`` in f32): in Python doubles the learning rate moves by an ulp.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # cosine | linear | constant
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_weights: bool = True


def _leaf_key(name: str, stacked: str):
    """JAX's order of a parameter: dict keys sorted, list items by index,
    and a stacked leaf's layer after its path."""
    parts = name.split(".")
    layer = ()
    if parts[0] == stacked:
        layer, parts = (int(parts[1]),), parts[:1] + parts[2:]
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in parts) + layer, ".".join(parts)


def named_leaves(params) -> List[Tuple[str, torch.Tensor]]:
    """``(JAX path, tensor)`` of every parameter in JAX's leaf order. An LM
    (a module with ``STACKED = "blocks"``) holds its blocks stacked in JAX,
    so each ``blocks.<i>.<rest>`` is listed under ``blocks.<rest>``, the
    layers of one leaf one after another."""
    if isinstance(params, nn.Module):
        items = list(params.named_parameters())
        stacked = getattr(params, "STACKED", "")
    else:
        items, stacked = list(params.items()), ""
    keyed = sorted((_leaf_key(n, stacked), t) for n, t in items)
    return [(path, t) for (_, path), t in keyed]


def leaves(params) -> List[torch.Tensor]:
    return [t for _, t in named_leaves(params)]


def groups(params) -> List[List[int]]:
    """Index runs of :func:`leaves` that form one JAX leaf."""
    out: List[List[int]] = []
    last = None
    for i, (path, _) in enumerate(named_leaves(params)):
        if path != last:
            out.append([])
            last = path
        out[-1].append(i)
    return out


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * t
    else:
        decay = torch.ones((), dtype=torch.float32, device=step.device)
    return cfg.lr * warm * decay


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    ps = leaves(params)
    st = {"m": [_zeros32(p) for p in ps], "v": [_zeros32(p) for p in ps],
          "step": torch.zeros((), dtype=torch.int32, device=ps[0].device)}
    if cfg.master_weights:
        st["master"] = [p.detach().to(torch.float32, copy=True) for p in ps]
    return st


def global_norm(tensors, runs=None) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in order; ``runs``
    (:func:`groups`) gathers a stacked leaf's layers into one term."""
    runs = runs or [[i] for i in range(len(tensors))]
    sq = [sum(torch.sum(torch.square(tensors[i].float())) for i in run)
          for run in runs]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def apply_updates(params, grads: List[torch.Tensor], state: Dict[str, Any],
                  cfg: AdamWConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and the state's tensors are updated in
    place and returned, with ``{"grad_norm", "lr"}``."""
    ps = leaves(params)
    step = state["step"] + 1
    gnorm = global_norm(grads, groups(params))
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0) if cfg.clip_norm > 0 else \
        torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    src = state.get("master", ps)
    for i, p in enumerate(ps):
        g = grads[i].float() * scale
        m, v = state["m"][i], state["v"][i]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        p32 = src[i].float()
        new = p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p32)
        if cfg.master_weights:
            src[i].copy_(new)
        p.copy_(new)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    if cfg.master_weights:
        new_state["master"] = state["master"]
    return params, new_state, {"grad_norm": gnorm, "lr": lr}

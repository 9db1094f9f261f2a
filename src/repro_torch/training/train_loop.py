"""Train-step factory: value_and_grad + AdamW + optional microbatch
accumulation + optional int8 error-feedback gradient compression. Port of
the JAX package's ``training/train_loop.py``.

Gradients come from ``torch.autograd`` over the model's parameters, in
``optimizer.named_leaves`` order. A model's parameters are made without
gradients (the serving path tracks none); :func:`trainable` switches them
on for the span of a step and back off after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List

import torch

from . import optimizer as optim
from .grad_compression import compress_with_error_feedback, init_error_feedback


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: optim.AdamWConfig = optim.AdamWConfig()
    grad_accum: int = 1            # microbatches per step
    compress_grads: bool = False   # int8 + error feedback


def init_train_state(params, cfg: TrainConfig) -> Dict[str, Any]:
    st = {"opt": optim.init_state(params, cfg.opt)}
    if cfg.compress_grads:
        st["ef"] = init_error_feedback(params)
    return st


@contextlib.contextmanager
def trainable(tensors: List[torch.Tensor]):
    """Gradients on for ``tensors`` inside the block, as they were after."""
    was = [t.requires_grad for t in tensors]
    try:
        for t in tensors:
            t.requires_grad_(True)
        with torch.enable_grad():
            yield
    finally:
        for t, w in zip(tensors, was):
            t.requires_grad_(w)


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` as ``jax.value_and_grad(loss_fn,
    has_aux=True)`` gives them: loss and metrics detached, one gradient a
    leaf of ``optimizer.leaves(params)`` in the parameter's dtype (zeros
    where the loss does not reach a leaf)."""
    ps = optim.leaves(params)
    with trainable(ps):
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, ps)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in (metrics or {}).items()}
    return (loss.detach(), metrics), grads


def make_train_step(loss_fn: Callable, cfg: TrainConfig) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics). Returns
    step(params, state, batch) -> (params, state, metrics); ``params`` and
    the state's tensors are updated in place."""

    def step(params, state, batch):
        if cfg.grad_accum > 1:
            # batch leaves are [accum * micro, ...] -> microbatches in turn
            n = cfg.grad_accum
            micro = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])
                     for k, x in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in optim.leaves(params)]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=grads[0].device)
            for i in range(n):
                (loss, _), g = value_and_grad(
                    loss_fn, params, {k: x[i] for k, x in micro.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                loss_sum = loss_sum + loss
            grads = [g / n for g in grads]
            loss = loss_sum / n
            metrics = {}
        else:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)

        new_state = dict(state)
        if cfg.compress_grads:
            grads, new_state["ef"] = compress_with_error_feedback(
                grads, state["ef"])
        params, new_state["opt"], opt_m = optim.apply_updates(
            params, grads, state["opt"], cfg.opt)
        out = {"loss": loss, **opt_m}
        for k, v in (metrics or {}).items():
            out[k] = v
        return params, new_state, out

    return step

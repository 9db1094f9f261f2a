"""Int8 gradient compression with error feedback (1-bit-Adam-family trick).
Port of the JAX package's ``training/grad_compression.py``.

For cross-pod data parallelism the gradient all-reduce over the (slow)
pod-interconnect dominates; int8 per-tensor-scaled quantization cuts those
bytes 4x (vs f32) / 2x (vs bf16). Error feedback accumulates the residual
so the compression bias vanishes over steps (Karimireddy et al., 2019).

On one card the quantize -> dequantize round trip around the optimizer
models the numerics (``train_loop`` with ``compress_grads``). Gradients
and the error feedback are lists in ``optimizer.named_leaves`` order.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payloads equal JAX's bit for bit. ``compressed_psum``, the collective
itself, comes with the sharded trainer (ROADMAP Queue 1 item 14.4b).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .optimizer import leaves


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32/bf16 -> (int8, scale). Symmetric per-tensor scaling."""
    g32 = g.float()
    amax = torch.max(torch.abs(g32))
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in leaves(params)]


def compress_with_error_feedback(grads, ef):
    """Returns (compressed-then-decompressed grads, new error feedback)."""
    outs, new_ef = [], []
    for g, e in zip(grads, ef):
        target = g.float() + e
        deq = dequantize(*quantize(target))
        outs.append(deq)
        new_ef.append(target - deq)
    return outs, new_ef


def compressed_psum(g: torch.Tensor, axis_name: str) -> torch.Tensor:
    """psum of an int8 payload across data-parallel ranks."""
    raise NotImplementedError(
        "compressed_psum needs the sharded trainer, not ported yet (ROADMAP "
        "Queue 1 item 14.4b)")

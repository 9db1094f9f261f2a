"""Association scoring body shared by the ranking kernels.

Port of the JAX package's ``kernels/assoc_score.py:score_body``. The plain
torch function here is the body's CPU form and oracle; its device twin is
``repro::score_body`` in ``csrc/assoc_score.cuh``, which the ``score_gate``
kernel inlines. Both run the same operations in the same order.

The JAX package's stand-alone ``assoc_score`` Pallas kernel has no engine
caller and is not ported in this slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-9


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x * torch.log(torch.clamp_min(x, 1e-30)),
                       torch.zeros_like(x))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))``, as ``jax.nn.sigmoid`` and the kernel compute it."""
    return 1.0 / (1.0 + torch.exp(-x))


def assoc_lanes(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c):
    """The four association lanes (condprob, pmi, llr, chi2) over f32 lanes;
    ``total_w``/``total_c`` are 0-d tensors. Degenerate entries -> 0."""
    zero = torch.zeros_like(w_ab)
    w_a = torch.clamp_min(w_a, 0.0)
    w_b = torch.clamp_min(w_b, 0.0)
    condprob = torch.where(w_a > 0, w_ab / torch.clamp_min(w_a, _EPS), zero)
    pmi = torch.where(
        (w_ab > 0) & (w_a > 0) & (w_b > 0),
        torch.log(torch.clamp_min(w_ab * torch.clamp_min(total_w, _EPS), _EPS)
                  / torch.clamp_min(w_a * w_b, _EPS)),
        zero)
    k11 = c_ab
    k12 = torch.clamp_min(c_a - c_ab, 0.0)
    k21 = torch.clamp_min(c_b - c_ab, 0.0)
    k22 = torch.clamp_min(total_c - c_a - c_b + c_ab, 0.0)
    n = torch.clamp_min(k11 + k12 + k21 + k22, _EPS)
    r1, r2 = k11 + k12, k21 + k22
    q1, q2 = k11 + k21, k12 + k22
    llr = 2.0 * (_xlogx(k11) + _xlogx(k12) + _xlogx(k21) + _xlogx(k22)
                 - _xlogx(r1) - _xlogx(r2) - _xlogx(q1) - _xlogx(q2)
                 + _xlogx(n))
    llr = torch.clamp_min(llr, 0.0)
    d = k11 * k22 - k12 * k21
    chi2 = n * (d * d) / torch.clamp_min(r1 * r2 * q1 * q2, _EPS)
    valid = c_ab > 0
    return (torch.where(valid, condprob, zero), torch.where(valid, pmi, zero),
            torch.where(valid, llr, zero), torch.where(valid, chi2, zero))


def combine(coefs: Tuple[float, float, float, float], condprob, pmi, llr,
            chi2) -> torch.Tensor:
    """The paper's linear combination (unbounded lanes squashed)."""
    c0, c1, c2, c3 = (float(c) for c in coefs)
    return (c0 * condprob + c1 * sigmoid(pmi)
            + c2 * torch.log1p(llr) + c3 * torch.log1p(chi2))


def score_body(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c,
               coefs: Tuple[float, float, float, float]) -> torch.Tensor:
    """Combined association score per slot (no gates, no decay)."""
    return combine(coefs, *assoc_lanes(w_ab, c_ab, w_a, w_b, c_a, c_b,
                                       total_w, total_c))

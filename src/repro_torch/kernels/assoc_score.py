"""Association scoring: the body shared by the ranking kernels, and the
stand-alone ``assoc_score`` kernel.

Port of the JAX package's ``kernels/assoc_score.py``. The plain torch
:func:`score_body` is the body's CPU form and oracle; its device twin is
``repro::score_body`` in ``csrc/assoc_score.cuh``, which the
``score_gate`` and ``region_rank`` kernels inline. Both run the same
operations in the same order.

:func:`assoc_score` is the JAX package's stand-alone Pallas kernel (the
four scores and their combination over full lanes, no gates, no decay):
``csrc/assoc_score.cu`` on CUDA tensors (gate first, as ``score_gate``: only
slots with ``c_ab > 0`` run the body, every other slot takes its value on
zeros), :func:`score_body` on CPU tensors. Neither package's engine calls
it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import LAUNCHES, check_launch, route
from .build import load

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


def _entry():
    fn = load("assoc_score").repro_assoc_score
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float] * 4
                   + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
    return fn


# The load routes of this kernel and score_gate's (csrc/score_tile.cuh):
# "vec", 16-byte loads and stores where every base is 16-byte aligned (a
# ragged last tile still runs slot by slot); "scalar", 4-byte ones
# everywhere.
ROUTE_LAUNCHES: Dict[str, int] = {"vec": 0, "scalar": 0}


def score_route(*ptrs: int) -> str:
    """The assoc_score and score_gate kernels' route for these base
    addresses (every lane's, the gate's and the output's): ``"vec"`` where
    all are 16-byte aligned, else ``"scalar"``."""
    return "vec" if all(p % 16 == 0 for p in ptrs) else "scalar"


def assoc_score(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c, *,
                coefs: Tuple[float, float, float, float]) -> torch.Tensor:
    """Combined association score per slot over f32[C] lanes (no gates, no
    decay); ``total_w``/``total_c`` are 0-d f32 tensors or numbers."""
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b)
    dev = w_ab.device
    totals = [torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())
              for x in (total_w, total_c)]
    if route(*lanes) == "plain":
        return score_body(*lanes, *totals, coefs)
    n = w_ab.shape[0]
    for t in lanes:
        if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError("score lanes must be contiguous float32 [C]")
    out = torch.empty_like(w_ab)
    launch_assoc_score(lanes, torch.stack(totals), coefs, out)
    return out


def launch_assoc_score(lanes, totals, coefs, out) -> None:
    """Launch the assoc_score kernel into ``out``, counting it. The bare
    launch under :func:`assoc_score`, which checks the lanes and stacks
    ``totals`` (f32[2]: total_w, total_c). The kernel takes the load route
    :func:`score_route` names for these bases."""
    if out.shape[0] == 0:
        return                      # C = 0: nothing to launch
    c0, c1, c2, c3 = (float(c) for c in coefs)
    code = _entry()(*[t.data_ptr() for t in lanes], totals.data_ptr(),
                    c0, c1, c2, c3, out.data_ptr(), out.shape[0],
                    torch.cuda.current_stream(out.device).cuda_stream)
    check_launch(code, "assoc_score")
    LAUNCHES["assoc_score"] += 1
    ROUTE_LAUNCHES[score_route(*(t.data_ptr() for t in (*lanes, out)))] += 1

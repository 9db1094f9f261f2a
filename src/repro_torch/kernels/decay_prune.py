"""Fused decay + prune sweep over a store's lanes.

Port of the JAX package's ``kernels/decay_prune.py``. On CUDA tensors
:func:`decay_prune_multi` launches ``csrc/decay_prune.cu`` (one read and
one write of every lane); on CPU tensors it runs the plain version
``ref.decay_prune_multi_ref``. :func:`decay_prune` is its single-lane
form. The CUDA kernel takes any capacity.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import LAUNCHES, check_launch, ref, route
from .build import load

MAX_AUX_LANES = 8


def _entry():
    fn = load("decay_prune").repro_decay_prune_multi
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int64, ctypes.c_void_p]
    return fn


def _check_lane(t: torch.Tensor, n: int, what: str) -> None:
    if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous 1-D lane of {n}, "
                         f"got {tuple(t.shape)}")
    if t.element_size() != 4:
        raise ValueError(f"{what}: need 4-byte elements, got {t.dtype}")


def decay_prune_multi(key_hi: torch.Tensor, key_lo: torch.Tensor,
                      weight_lanes: Sequence[torch.Tensor],
                      aux_lanes: Sequence[torch.Tensor],
                      decay_factor, threshold: float
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Tuple[torch.Tensor, ...],
                                 Tuple[torch.Tensor, ...],
                                 torch.Tensor, torch.Tensor]:
    """One sweep: decay the weight lanes by ``decay_factor``, keep a slot
    iff its key is live and the decayed primary weight is at least
    ``threshold``, clear keys, weights and aux lanes elsewhere.

    Keys are int32 bit views of u32; weight lanes f32; aux lanes any 4-byte
    type. The CUDA kernel takes one weight lane, as every store has; the
    plain version takes any number. Returns (key_hi', key_lo',
    weight_lanes', aux_lanes', live_count i32[], total_weight f32[]); the
    two scalars are plain reductions over the output lanes on both routes.
    """
    weight_lanes, aux_lanes = tuple(weight_lanes), tuple(aux_lanes)
    if route(key_hi, key_lo, *weight_lanes, *aux_lanes) == "plain":
        return ref.decay_prune_multi_ref(key_hi, key_lo, weight_lanes,
                                         aux_lanes, decay_factor, threshold)
    n = key_hi.shape[0]
    if len(weight_lanes) != 1:
        raise ValueError("the CUDA kernel takes exactly one weight lane, "
                         f"got {len(weight_lanes)}")
    if len(aux_lanes) > MAX_AUX_LANES:
        raise ValueError(f"at most {MAX_AUX_LANES} aux lanes")
    (w,) = weight_lanes
    for i, t in enumerate((key_hi, key_lo, w, *aux_lanes)):
        _check_lane(t, n, f"lane {i}")
    if w.dtype != torch.float32:
        raise ValueError(f"the weight lane must be float32, got {w.dtype}")
    out_hi, out_lo = torch.empty_like(key_hi), torch.empty_like(key_lo)
    w_out = torch.empty_like(w)
    a_out = tuple(torch.empty_like(a) for a in aux_lanes)
    launch(key_hi, key_lo, w, aux_lanes, out_hi, out_lo, w_out, a_out,
           decay_factor, threshold)
    keep = (out_hi != 0) | (out_lo != 0)
    return (out_hi, out_lo, (w_out,), a_out, keep.sum(dtype=torch.int32),
            w_out.sum())


def decay_prune(key_hi: torch.Tensor, key_lo: torch.Tensor,
                weight: torch.Tensor, decay_factor, threshold: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor]:
    """Single-lane sweep over (key_hi, key_lo, weight): the same kernel
    with no aux lanes. Returns (key_hi', key_lo', weight', live_count
    i32[], total_weight f32[]). A caller clears a store's other lanes by
    the returned keys (a pruned slot has key (0, 0)), or sweeps them in
    the one pass with :func:`decay_prune_multi`.
    """
    kh, kl, (w,), _, live, tot = decay_prune_multi(
        key_hi, key_lo, (weight,), (), decay_factor, threshold)
    return kh, kl, w, live, tot


def launch(key_hi, key_lo, w, aux_lanes, out_hi, out_lo, w_out, a_out,
           decay_factor, threshold: float) -> None:
    """Launch the CUDA kernel into the given output lanes, counting it.

    The bare launch under :func:`decay_prune_multi`, which checks and
    allocates the lanes; a caller passes CUDA lanes of equal length.
    """
    a_ptrs = (ctypes.c_uint64 * max(2 * len(a_out), 1))(
        *[t.data_ptr() for t in (*aux_lanes, *a_out)])
    code = _entry()(key_hi.data_ptr(), key_lo.data_ptr(), w.data_ptr(),
                    out_hi.data_ptr(), out_lo.data_ptr(), w_out.data_ptr(),
                    a_ptrs, len(a_out), float(decay_factor), float(threshold),
                    key_hi.shape[0],
                    torch.cuda.current_stream(key_hi.device).cuda_stream)
    check_launch(code, "decay_prune_multi")
    LAUNCHES["decay_prune_multi"] += 1

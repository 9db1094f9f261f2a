"""Batched weighted edit distance: the spelling job's all-pairs kernel.

Port of the JAX package's ``kernels/edit_distance.py``. On CUDA tensors
:func:`edit_distance` launches ``csrc/edit_distance.cu``; on CPU tensors it
runs the plain version ``ref.edit_distance_ref``, which the kernel equals
bit for bit on both of its routes (:func:`kernel_route`):

* ``"half"``, when ``2 * first_char_cost`` (as f32) is an integer in
  ``[0, 1024]``, the job's 1.5 included: an integer table in half units,
  two pairs a thread on Hopper's 16-bit DPX instructions;
* ``"f32"`` for any other cost: the plain version's f32 adds and mins, one
  pair a thread.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from . import LAUNCHES, check_launch, ref, route
from .build import load

# The largest half-unit weight 2 * first_char_cost the half route takes
# (the kernel's kMaxHalfWeight): every lane sum stays far below 2^15.
MAX_HALF_WEIGHT = 1 << 10

# Launches per kernel route, counted beside LAUNCHES["edit_distance"].
ROUTE_LAUNCHES: Dict[str, int] = {"half": 0, "f32": 0}


def _lib():
    lib = load("edit_distance")
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int]
    lib.repro_edit_distance.restype = ctypes.c_int
    lib.repro_edit_distance.argtypes = args + [ctypes.c_float,
                                               ctypes.c_void_p]
    lib.repro_edit_distance_half.restype = ctypes.c_int
    lib.repro_edit_distance_half.argtypes = args + [ctypes.c_int,
                                                    ctypes.c_void_p]
    lib.repro_edit_distance_max_len.restype = ctypes.c_int
    lib.repro_edit_distance_max_len.argtypes = []
    return lib


def half_unit_weight(first_char_cost: float) -> Optional[int]:
    """``2 * first_char_cost`` as an int when the half-unit route takes it,
    else None.

    The cost is read as the f32 the plain version computes with. The
    route needs ``2 * fc`` to be an integer in ``[0, MAX_HALF_WEIGHT]``
    and ``fc`` not to be ``-0.0``, whose f32 table holds ``-0.0`` where the
    integer table holds ``+0``.
    """
    fc = float(torch.tensor(first_char_cost, dtype=torch.float32))
    w = 2.0 * fc
    if not (math.isfinite(w) and w == math.floor(w)
            and 0 <= w <= MAX_HALF_WEIGHT and math.copysign(1.0, fc) > 0):
        return None
    return int(w)


def kernel_route(first_char_cost: float) -> str:
    """The CUDA kernel's route for this cost: ``"half"`` or ``"f32"``."""
    return "f32" if half_unit_weight(first_char_cost) is None else "half"


def _check(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need {dtype} {list(shape)}, got "
                         f"{t.dtype} {list(t.shape)}")


def edit_distance(a_chars: torch.Tensor, a_len: torch.Tensor,
                  b_chars: torch.Tensor, b_len: torch.Tensor, *,
                  first_char_cost: float = 1.5) -> torch.Tensor:
    """Weighted optimal-string-alignment distance per pair.

    ``a_chars``/``b_chars`` u8[B, L] zero-padded, ``a_len``/``b_len``
    i32[B] in [0, L]. Edits touching either string's first character cost
    ``first_char_cost``, other edits and adjacent transpositions 1.
    Returns f32[B]. The CUDA kernel raises for L above its maximum (32)
    and takes contiguous tensors at any base address.
    """
    B, L = a_chars.shape
    _check(a_chars, torch.uint8, (B, L), "a_chars")
    _check(b_chars, torch.uint8, (B, L), "b_chars")
    _check(a_len, torch.int32, (B,), "a_len")
    _check(b_len, torch.int32, (B,), "b_len")
    if route(a_chars, a_len, b_chars, b_len) == "plain":
        return ref.edit_distance_ref(a_chars, a_len, b_chars, b_len,
                                     first_char_cost)
    max_len = _lib().repro_edit_distance_max_len()
    if L > max_len:
        raise ValueError(f"edit_distance: string length {L} exceeds the "
                         f"kernel's {max_len}")
    for t, what in ((a_chars, "a_chars"), (a_len, "a_len"),
                    (b_chars, "b_chars"), (b_len, "b_len")):
        if not t.is_contiguous():
            raise ValueError(f"{what}: need a contiguous tensor")
    out = torch.empty((B,), dtype=torch.float32, device=a_chars.device)
    launch(a_chars, a_len, b_chars, b_len, out, first_char_cost)
    return out


def launch(a_chars, a_len, b_chars, b_len, out, first_char_cost) -> None:
    """Launch the kernel into ``out`` f32[B] on :func:`kernel_route`'s
    route, counting it. The bare launch under :func:`edit_distance`, which
    checks the inputs and allocates ``out``."""
    B, L = a_chars.shape
    lib = _lib()
    w = half_unit_weight(first_char_cost)
    ptrs = (a_chars.data_ptr(), a_len.data_ptr(), b_chars.data_ptr(),
            b_len.data_ptr(), out.data_ptr(), B, L)
    stream = torch.cuda.current_stream(a_chars.device).cuda_stream
    if w is None:
        code = lib.repro_edit_distance(*ptrs, float(first_char_cost), stream)
    else:
        code = lib.repro_edit_distance_half(*ptrs, w, stream)
    check_launch(code, "edit_distance")
    LAUNCHES["edit_distance"] += 1
    ROUTE_LAUNCHES["f32" if w is None else "half"] += 1

"""Batched weighted edit distance: the spelling job's all-pairs kernel.

Port of the JAX package's ``kernels/edit_distance.py``. On CUDA tensors
:func:`edit_distance` launches ``csrc/edit_distance.cu`` (one thread per
pair, DP rows in registers); on CPU tensors it runs the plain version
``ref.edit_distance_ref``, which the kernel equals bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_launch, ref, route
from .build import load


def _lib():
    lib = load("edit_distance")
    lib.repro_edit_distance.restype = ctypes.c_int
    lib.repro_edit_distance.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.repro_edit_distance_max_len.restype = ctypes.c_int
    lib.repro_edit_distance_max_len.argtypes = []
    return lib


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
    Returns f32[B]. The CUDA kernel raises for L above its maximum (32).
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
    """Launch the kernel into ``out`` f32[B], counting it. The bare launch
    under :func:`edit_distance`, which checks the inputs and allocates
    ``out``."""
    B, L = a_chars.shape
    code = _lib().repro_edit_distance(
        a_chars.data_ptr(), a_len.data_ptr(), b_chars.data_ptr(),
        b_len.data_ptr(), out.data_ptr(), B, L, float(first_char_cost),
        torch.cuda.current_stream(a_chars.device).cuda_stream)
    check_launch(code, "edit_distance")
    LAUNCHES["edit_distance"] += 1

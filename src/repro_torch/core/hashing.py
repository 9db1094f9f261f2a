"""64-bit fingerprints and table hashing on 32-bit lanes.

Host half (numpy / python ints): FNV-1a fingerprints, ``split_fp`` /
``join_fp`` and the numpy pair combine — copies of the JAX package's host
code, so this package never imports it.

Device half (torch): ``_mix32``, ``probe_hash`` and ``combine_fp_device``,
bit-identical to the JAX package's uint32 arithmetic.

**The u32 representation.** torch has no ``>>``/``<`` on ``torch.uint32``
on every device, so:

  * table lanes that hold u32 values are stored as ``torch.int32`` bit views
    (the same four bytes a CUDA kernel reads as ``uint32_t``; the host views
    them back as ``np.uint32`` at no cost);
  * arithmetic, shifts, ordering and packing widen to int64 holding the
    value in ``[0, 2**32)`` (:func:`u32`), and narrow back with :func:`to_i32`;
  * multiplication goes through :func:`mul32`, which splits the constant
    into 16-bit halves so that no intermediate reaches 2**63;
  * equality tests stay on the int32 views.
"""
from __future__ import annotations

import numpy as np
import torch

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1
MASK32 = 0xFFFFFFFF


def fnv1a_64(data: bytes) -> int:
    """FNV-1a 64-bit hash of a byte string. fp 0 is reserved -> remapped to 1."""
    h = FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * FNV_PRIME) & _MASK64
    return h or 1


def fingerprint(text: str) -> int:
    return fnv1a_64(text.encode("utf-8"))


def combine_fp(a: int, b: int) -> int:
    """Order-sensitive 64-bit combine of two fingerprints (directed pairs)."""
    h = (a ^ 0x9E3779B97F4A7C15) & _MASK64
    h = (h * FNV_PRIME) & _MASK64
    h ^= b
    h = (h * FNV_PRIME) & _MASK64
    h ^= h >> 29
    return h or 1


def split_fp(fp) -> tuple:
    """fp64 -> (hi, lo) uint32 pair. Works on python ints and numpy arrays."""
    if isinstance(fp, (int, np.integer)):
        return np.uint32((fp >> 32) & MASK32), np.uint32(fp & MASK32)
    fp = np.asarray(fp, dtype=np.uint64)
    return ((fp >> np.uint64(32)).astype(np.uint32),
            (fp & np.uint64(MASK32)).astype(np.uint32))


def join_fp(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 -> fp64 numpy uint64 (host-side only)."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


def _mix32_np(x):
    x = np.asarray(x, np.uint32).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint32(16)
        x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
        x ^= x >> np.uint32(13)
        x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
        x ^= x >> np.uint32(16)
    return x


def combine_fp_np(a_hi, a_lo, b_hi, b_lo):
    """numpy mirror of :func:`combine_fp_device`."""
    with np.errstate(over="ignore"):
        h1 = _mix32_np(np.asarray(a_hi, np.uint32) ^ np.uint32(0x9E3779B9))
        h1 = _mix32_np((h1 * np.uint32(0x85EBCA6B)).astype(np.uint32)
                       ^ np.asarray(b_hi, np.uint32))
        h2 = _mix32_np((np.asarray(a_lo, np.uint32) * np.uint32(0xC2B2AE35)
                        ).astype(np.uint32) ^ np.uint32(0x27D4EB2F))
        h2 = _mix32_np(h2 ^ (np.asarray(b_lo, np.uint32)
                             * np.uint32(0x165667B1)).astype(np.uint32))
    h2 = np.where((h1 == 0) & (h2 == 0), np.uint32(1), h2)
    return h1, h2


# ---------------------------------------------------------------------------
# The u32 representation.
# ---------------------------------------------------------------------------

def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit view (or any int tensor) -> int64 holding the u32 value."""
    return x.to(torch.int64) & MASK32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> its int32 bit view (explicit wrap)."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a u32 constant
    ``c``; both partial products stay below 2**48."""
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def from_np_u32(a, device) -> torch.Tensor:
    """numpy uint32 array -> int32 bit-view tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_np_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-view tensor -> numpy uint32 array (no value change)."""
    return t.detach().cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Device-side 32-bit mixing (int64 lanes holding u32 values in and out).
# ---------------------------------------------------------------------------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer — avalanche a u32 lane."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def probe_hash(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Initial probe position hash from a (hi, lo) fingerprint pair."""
    return _mix32(mul32(u32(hi), 0x9E3779B9) ^ _mix32(u32(lo)))


def combine_fp_device(a_hi, a_lo, b_hi, b_lo):
    """Order-sensitive pair fingerprint -> (hi, lo) int32 bit views.

    Same function as the JAX package's ``combine_fp_device``; (0, 0) is
    reserved as the empty marker.
    """
    h1 = _mix32(u32(a_hi) ^ 0x9E3779B9)
    h1 = _mix32(mul32(h1, 0x85EBCA6B) ^ u32(b_hi))
    h2 = _mix32(mul32(u32(a_lo), 0xC2B2AE35) ^ 0x27D4EB2F)
    h2 = _mix32(h2 ^ mul32(u32(b_lo), 0x165667B1))
    h2 = torch.where((h1 == 0) & (h2 == 0), torch.ones_like(h2), h2)
    return to_i32(h1), to_i32(h2)

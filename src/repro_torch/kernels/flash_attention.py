"""Flash attention forward: causal, sliding-window, GQA.

Port of the JAX package's ``kernels/flash_attention.py``. On CUDA tensors
:func:`flash_attention` launches ``csrc/flash_attention.cu``, which visits
the K/V tiles of the causal/window band only with an online softmax in f32:
bf16 on the tensor cores (wgmma, K/V by TMA; P is rounded to bf16 before
P.V, as on any tensor-core attention), f32 on the CUDA cores. On CPU
tensors it runs the plain version ``ref.flash_attention_ref``.

Causal attention with ``Tq > Tk`` raises on both routes: its first rows have
no valid key, where the JAX reference gives NaN and the Pallas kernel the
mean of ``v`` over its first key block. No caller of either package asks
for it (the cache-free forward has ``Tq == Tk``).
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_launch, ref, route
from .build import load

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = load("flash_attention")
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_flash_attention.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 12
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.repro_flash_attention_max_d.restype = ctypes.c_int
    lib.repro_flash_attention_max_d.argtypes = []
    return lib


def _check(q, k, v, causal: bool) -> None:
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.dim() != 4:
            raise ValueError(f"{what}: need [B, H, T, D], got {tuple(t.shape)}")
    B, Hq, Tq, D = q.shape
    _, Hkv, Tk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of KV heads {Hkv}")
    if min(Tq, Tk) == 0:
        raise ValueError("empty query or key sequence")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"need q, k, v all bfloat16 or all float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if causal and Tq > Tk:
        raise ValueError(f"causal attention with Tq {Tq} > Tk {Tk}: the "
                         "first rows would have no valid key")


def _check_tma(t: torch.Tensor, what: str) -> None:
    """The bf16 kernel reads and writes through TMA tensor maps: 16-byte
    aligned base, and b/h/t strides of dims longer than 1 in 16 bytes."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: base address not 16-byte aligned")
    for dim, name in ((0, "b"), (1, "h"), (2, "t")):
        nbytes = t.stride(dim) * t.element_size()
        if t.shape[dim] > 1 and nbytes % 16:
            raise ValueError(f"{what}: {name}-stride of {nbytes} bytes is not "
                             "a multiple of 16 (TMA)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D] -> [B, Hq, Tq, D] in q.dtype.

    ``window > 0`` keeps keys with ``kpos > qpos - window``; query rows are
    end-aligned. The CUDA kernel takes bf16 or f32, D a multiple of 8 up to
    128, any b/h/t strides with a contiguous last dim (bf16: base addresses
    and the strides of dimensions longer than 1 multiples of 16 bytes, as
    TMA needs); the output has q's layout (``torch.empty_like``).
    """
    _check(q, k, v, causal)
    D = q.shape[3]
    scale = ref.attention_scale(D) if scale is None else float(scale)
    if route(q, k, v) == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale)
    max_d = _lib().repro_flash_attention_max_d()
    if D % 8 or D > max_d:
        raise ValueError(f"flash_attention: head dim {D} is not a multiple "
                         f"of 8 up to {max_d}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"{what}: need a contiguous last dim")
        if t.dtype == torch.bfloat16:
            _check_tma(t, what)
    out = torch.empty_like(q)
    launch(q, k, v, out, causal, window, scale)
    return out


def launch(q, k, v, out, causal: bool, window: int, scale: float) -> None:
    """Launch the kernel into ``out`` (q's shape), counting it. The bare
    launch under :func:`flash_attention`, which checks the inputs and
    allocates ``out``."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    code = _lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, Hq, Hkv, Tq, Tk, D, *strides, int(bool(causal)),
        int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1

"""Region-layout chain find: match each pair's dst key along its chain.

Port of the JAX package's ``kernels/region_probe.py`` (``chain_find_depth``
and the ``chain_find`` loop over it). On CUDA tensors :func:`chain_find`
launches ``csrc/chain_find.cu`` once for the whole chain (one warp per
batch row); on CPU tensors it runs the plain version
``ref.chain_find_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, check_launch, ref, route
from .build import load


def _lib():
    lib = load("chain_find")
    lib.repro_chain_find.restype = ctypes.c_int
    lib.repro_chain_find.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.repro_chain_find_max_width.restype = ctypes.c_int
    lib.repro_chain_find_max_width.argtypes = []
    return lib


def _check(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous {dtype} "
                         f"{list(shape)}, got {t.dtype} {list(t.shape)}")


def chain_find(key_hi_r: torch.Tensor, key_lo_r: torch.Tensor,
               regs: torch.Tensor, dst_hi: torch.Tensor,
               dst_lo: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Global slot (region * W + position) of each row's dst key along its
    chain, or -1.

    ``key_hi_r``/``key_lo_r`` are the store's key lanes viewed as
    ``[n_regions, W]`` (int32 bit views of u32), ``regs`` i32[B, MC] the
    chain (-1 = no region at that depth), ``dst_hi``/``dst_lo`` i32[B],
    ``active`` bool[B]. Returns i32[B]. The CUDA kernel keeps a region row
    in one warp's registers, so it raises for W above 128.
    """
    if route(key_hi_r, key_lo_r, regs, dst_hi, dst_lo, active) == "plain":
        return ref.chain_find_ref(key_hi_r, key_lo_r, regs, dst_hi, dst_lo,
                                  active)
    R, W = key_hi_r.shape
    B, MC = regs.shape
    lib = _lib()
    if W > lib.repro_chain_find_max_width():
        raise ValueError(f"chain_find: region width {W} exceeds the "
                         f"kernel's {lib.repro_chain_find_max_width()}")
    if R * W >= 2**31:
        raise ValueError("chain_find: slots must fit in int32")
    _check(key_hi_r, torch.int32, (R, W), "key_hi_r")
    _check(key_lo_r, torch.int32, (R, W), "key_lo_r")
    _check(regs, torch.int32, (B, MC), "regs")
    _check(dst_hi, torch.int32, (B,), "dst_hi")
    _check(dst_lo, torch.int32, (B,), "dst_lo")
    _check(active, torch.bool, (B,), "active")
    out = torch.empty((B,), dtype=torch.int32, device=regs.device)
    launch_chain_find(key_hi_r, key_lo_r, regs, dst_hi, dst_lo, active, out)
    return out


def launch_chain_find(key_hi_r, key_lo_r, regs, dst_hi, dst_lo, active,
                      out) -> None:
    """Launch the chain_find kernel into ``out`` i32[B], counting it. The
    bare launch under :func:`chain_find`, which checks the inputs and
    allocates ``out``."""
    W = key_hi_r.shape[1]
    B, MC = regs.shape
    code = _lib().repro_chain_find(
        key_hi_r.data_ptr(), key_lo_r.data_ptr(), W, regs.data_ptr(), MC,
        dst_hi.data_ptr(), dst_lo.data_ptr(), active.data_ptr(),
        out.data_ptr(), B, torch.cuda.current_stream(regs.device).cuda_stream)
    check_launch(code, "chain_find")
    LAUNCHES["chain_find"] += 1

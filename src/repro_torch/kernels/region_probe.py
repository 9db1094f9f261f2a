"""Region-layout chain find: match each pair's dst key along its chain.

Port of the JAX package's ``kernels/region_probe.py`` (``chain_find_depth``
and the ``chain_find`` loop over it; here :func:`chain_find_depth` is
:func:`chain_find` on a one-column chain). On CUDA tensors :func:`chain_find`
launches ``csrc/chain_find.cu`` once for the whole chain (a warp owns up
to 32 batch rows, :func:`rows_per_warp`, and walks their active ones), on
one of two routes
(:func:`kernel_route`); on CPU tensors it runs the plain version
``ref.chain_find_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import LAUNCHES, check_launch, ref, route
from .build import load


def _lib():
    lib = load("chain_find")
    lib.repro_chain_find.restype = ctypes.c_int
    lib.repro_chain_find.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.repro_chain_find_max_width.restype = ctypes.c_int
    lib.repro_chain_find_max_width.argtypes = []
    lib.repro_chain_find_resident_warps.restype = ctypes.c_int
    lib.repro_chain_find_resident_warps.argtypes = [ctypes.c_int,
                                                    ctypes.c_int]
    return lib


# chain_find's two kernel routes (csrc/chain_find.cu), chosen by the key
# lanes: "vec", a lane reads four slots of a region row as one 16-byte load;
# "scalar", a lane reads slots l, l + 32, ... as 4-byte loads.
ROUTE_LAUNCHES: Dict[str, int] = {"vec": 0, "scalar": 0}
# Waves of the kernel's resident warps a launch should not exceed while a
# warp can take more rows (:func:`target_warps`). Set by the time at each
# rows-a-warp that chip_smoke.py prints for the region path's two batch
# sizes: on an H100, 8 waves give the fastest of 1-32 rows a warp on both
# (16 at 524,288 rows, where 32 took ~25% longer; 1 at 20,480).
WAVES = 8


def kernel_route(key_hi_r: torch.Tensor, key_lo_r: torch.Tensor) -> str:
    """The CUDA kernel's route for these key lanes: ``"vec"`` where the
    region width is a multiple of 4 and both bases are 16-byte aligned,
    else ``"scalar"``."""
    W = key_hi_r.shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (key_hi_r, key_lo_r))
    return "vec" if W % 4 == 0 and aligned else "scalar"


@functools.lru_cache(maxsize=None)
def _target_warps(index: int, W: int, vec: bool) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    with torch.cuda.device(index):
        resident = _lib().repro_chain_find_resident_warps(W, int(vec))
    if resident <= 0:
        raise RuntimeError(f"chain_find: no occupancy for W={W}, "
                           f"vec={vec}")
    return WAVES * resident * sms


def target_warps(device: torch.device, W: int, vec: bool) -> int:
    """``WAVES`` waves of the warps the card holds at once of the kernel
    instance for width ``W`` on the given route: the SM count times the
    resident warps the CUDA runtime's occupancy calculator gives for the
    built kernel (48 an SM on an H100 at 38-40 registers), so the rows a
    warp follow the card and the kernel's registers."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _target_warps(index, W, vec)


def rows_per_warp(B: int, target: int) -> int:
    """The batch rows a warp of the CUDA kernel owns: the smallest power of
    two, up to 32, that leaves at most ``target`` warps (:func:`target_warps`)
    for ``B`` rows. On an H100 the engine's largest batches (524,288 rows,
    mostly inactive) give each warp 16 rows, one flag read for all of them;
    its small dense ones (20,480 rows) one warp a row, so their active rows
    are walked side by side."""
    rpw = 1
    while rpw < 32 and B > rpw * target:
        rpw *= 2
    return rpw


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
    ``active`` bool[B]. Returns i32[B]. The CUDA kernel reads a region row
    with one warp, at most four slots a lane, so it raises for W above
    128. It takes any base address.
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


def chain_find_depth(key_hi_r: torch.Tensor, key_lo_r: torch.Tensor,
                     region_ids: torch.Tensor, dst_hi: torch.Tensor,
                     dst_lo: torch.Tensor) -> torch.Tensor:
    """Match each row's dst key against one region row: the in-region
    position of its first match, or ``W`` where the key is absent there.

    ``region_ids`` i32[B] picks each row's region and must hold valid
    region ids. This is :func:`chain_find` on a one-column chain with
    every row active (on CUDA the same ``chain_find.cu`` launch), the
    found slot taken back to its position in the region. Returns i32[B].
    """
    W = key_hi_r.shape[1]
    regs = region_ids.to(torch.int32).reshape(-1, 1).contiguous()
    active = torch.ones((regs.shape[0],), dtype=torch.bool,
                        device=regs.device)
    found = chain_find(key_hi_r, key_lo_r, regs, dst_hi, dst_lo, active)
    return torch.where(found >= 0, found - regs[:, 0] * W,
                       torch.full_like(found, W))


def launch_chain_find(key_hi_r, key_lo_r, regs, dst_hi, dst_lo, active,
                      out, kroute=None, rpw=None) -> None:
    """Launch the chain_find kernel into ``out`` i32[B] on ``kroute``
    (default :func:`kernel_route`'s) with ``rpw`` rows a warp (default
    :func:`rows_per_warp`'s), counting it. The bare launch under
    :func:`chain_find`, which checks the inputs and allocates ``out``."""
    W = key_hi_r.shape[1]
    B, MC = regs.shape
    kroute = kernel_route(key_hi_r, key_lo_r) if kroute is None else kroute
    vec = kroute == "vec"
    if rpw is None:
        rpw = rows_per_warp(B, target_warps(regs.device, W, vec))
    code = _lib().repro_chain_find(
        key_hi_r.data_ptr(), key_lo_r.data_ptr(), W, regs.data_ptr(), MC,
        dst_hi.data_ptr(), dst_lo.data_ptr(), active.data_ptr(),
        out.data_ptr(), B, int(vec), rpw,
        torch.cuda.current_stream(regs.device).cuda_stream)
    check_launch(code, "chain_find")
    LAUNCHES["chain_find"] += 1
    ROUTE_LAUNCHES[kroute] += 1

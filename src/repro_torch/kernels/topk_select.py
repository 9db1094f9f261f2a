"""Ranking kernels: the score/gate pass, the per-bucket top-k and the fused
region pass.

Port of the JAX package's ``kernels/topk_select.py`` (``score_gate``,
``bucket_topk`` and ``region_rank``). On CUDA tensors the wrappers launch
``csrc/score_gate.cu`` (on one of two load routes, :func:`score_route`),
``csrc/bucket_topk.cu`` and ``csrc/region_rank.cu`` (each on one of two
routes, :func:`kernel_route`);
on CPU tensors they run the plain versions in ``ref.py``. The kernels take
any capacity and any row count, so the Pallas version's tile padding is
gone.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import LAUNCHES, check_launch, ref, route
from .assoc_score import score_route
from .build import load


def _score_gate_entry():
    fn = load("score_gate").repro_score_gate
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_float] * 8
                   + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
    return fn


def _bucket_topk_lib():
    lib = load("bucket_topk")
    lib.repro_bucket_topk.restype = ctypes.c_int
    lib.repro_bucket_topk.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.repro_bucket_topk_rows.restype = ctypes.c_int
    lib.repro_bucket_topk_rows.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 3)
    lib.repro_bucket_topk_max_width.restype = ctypes.c_int
    lib.repro_bucket_topk_max_width.argtypes = []
    return lib


def _region_rank_lib():
    lib = load("region_rank")
    lib.repro_region_rank.restype = ctypes.c_int
    lib.repro_region_rank.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_float] * 8
        + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 4)
    lib.repro_region_rank_rows.restype = ctypes.c_int
    lib.repro_region_rank_rows.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_float] * 8
        + [ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    lib.repro_region_rank_max_width.restype = ctypes.c_int
    lib.repro_region_rank_max_width.argtypes = []
    return lib


def decay_exp2(w_ab, last_tick, now, half_life: float):
    """``w_ab * exp2(-max(now - last_tick, 0) / half_life)``, the kernels'
    in-pass read-time decay. The division is elementwise: on CUDA, torch
    divides by a Python number as a multiply by its reciprocal, which can
    round one ulp away from the kernels' (and the JAX kernels') quotient."""
    dt = torch.clamp_min(torch.as_tensor(now, dtype=torch.float32,
                                         device=w_ab.device)
                         - last_tick.to(torch.float32), 0.0)
    return w_ab * torch.exp2(-dt / torch.full_like(dt, half_life))


def score_gate(w_ab, c_ab, w_a, w_b, c_a, c_b, ok, last_tick, total_w,
               total_c, now, *, coefs: Tuple[float, float, float, float],
               min_pair_weight: float, min_src_weight: float,
               min_pair_count: float, half_life: Optional[float] = None
               ) -> torch.Tensor:
    """(Lazy decay +) association scoring + evidence gates over full lanes.

    ``w_ab .. c_b`` are f32[C], ``ok`` bool[C] (the base gate), ``total_w``
    and ``total_c`` 0-d f32 tensors. ``half_life`` enables the exponential
    read-time decay of ``w_ab`` from ``last_tick`` (i32[C]) to ``now``; pass
    None when ``w_ab`` is already the effective weight. Returns the gated
    combined score, ``-inf`` where a gate fails.
    """
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b)
    if route(*lanes, ok) == "plain":
        if half_life is not None:
            w_ab = decay_exp2(w_ab, last_tick, now, half_life)
        return ref.score_gate_ref(w_ab, c_ab, w_a, w_b, c_a, c_b, ok,
                                  total_w, total_c, coefs, min_pair_weight,
                                  min_src_weight, min_pair_count)
    n = w_ab.shape[0]
    for t in lanes:
        if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError("score lanes must be contiguous float32 [C]")
    if ok.dtype != torch.bool or ok.shape != (n,) or not ok.is_contiguous():
        raise ValueError("ok must be a contiguous bool [C]")
    dev = w_ab.device
    lt_ptr = None
    if half_life is not None:
        if (last_tick.dtype != torch.int32 or last_tick.shape != (n,)
                or not last_tick.is_contiguous() or last_tick.device != dev):
            raise ValueError("last_tick must be a contiguous int32 [C] "
                             "on the lanes' device")
        lt_ptr = last_tick.data_ptr()
    scalars = torch.stack([
        torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())
        for x in (total_w, total_c, 0 if now is None else now)])
    out = torch.empty_like(w_ab)
    launch_score_gate(lanes, ok, lt_ptr, scalars, coefs,
                      (min_pair_weight, min_src_weight, min_pair_count),
                      half_life, out)
    return out


def launch_score_gate(lanes, ok, lt_ptr, scalars, coefs, gates, half_life,
                      out) -> None:
    """Launch the score_gate kernel into ``out``, counting it.

    The bare launch under :func:`score_gate`, which checks the lanes and
    stacks ``scalars`` (f32[3]: total_w, total_c, now); ``lt_ptr`` is the
    ``last_tick`` lane's pointer, or None without ``half_life``. The kernel
    takes the load route :func:`score_route` names for these bases: a view
    whose base is not 16-byte aligned (``lane[1:]``) takes the 4-byte one.
    """
    if out.shape[0] == 0:
        return                      # C = 0: nothing to launch
    c0, c1, c2, c3 = (float(c) for c in coefs)
    code = _score_gate_entry()(
        *[t.data_ptr() for t in lanes], ok.data_ptr(), lt_ptr,
        scalars.data_ptr(), c0, c1, c2, c3, *(float(g) for g in gates),
        0.0 if half_life is None else float(half_life), out.data_ptr(),
        out.shape[0], torch.cuda.current_stream(out.device).cuda_stream)
    check_launch(code, "score_gate")
    LAUNCHES["score_gate"] += 1
    ptrs = [t.data_ptr() for t in (*lanes, ok, out)]
    if half_life is not None:
        ptrs.append(lt_ptr)
    SCORE_ROUTE_LAUNCHES[score_route(*ptrs)] += 1


# score_gate's launches by load route (assoc_score.score_route names it).
SCORE_ROUTE_LAUNCHES: Dict[str, int] = {"vec": 0, "scalar": 0}


# bucket_topk's two kernel routes (csrc/bucket_topk.cu), chosen by K:
# "row", one thread per row over a shared-memory tile, for K up to
# ROW_MAX_K; "warp", one warp per row, for any K.
ROW_MAX_K = 32
ROW_KMAX = (8, 16, 32)          # the row kernel's list lengths
ROW_TILE_ROWS = (128, 64)       # rows a block at L <= 64, at wider L
SMEM_PER_BLOCK = 232448         # 227 KB of shared memory a block (sm_90)

# Launches per kernel route, counted beside LAUNCHES["bucket_topk"] and
# LAUNCHES["region_rank"]. region_rank's routes (csrc/region_rank.cu) are
# chosen by the same rule: "row", gate first, score only the passing slots
# and one thread a row's top-k, for K up to ROW_MAX_K; "warp", one warp per
# region row, for any K.
ROUTE_LAUNCHES: Dict[str, int] = {"row": 0, "warp": 0}
REGION_ROUTE_LAUNCHES: Dict[str, int] = {"row": 0, "warp": 0}


def kernel_route(k: int) -> str:
    """The CUDA kernels' route for top-``k`` (``bucket_topk`` and
    ``region_rank``): ``"row"`` or ``"warp"``."""
    return "row" if k <= ROW_MAX_K else "warp"


def row_kmax(k: int) -> int:
    """The row kernel's list length for top-``k``: the smallest of
    ``ROW_KMAX`` at or above ``k``."""
    return next(m for m in ROW_KMAX if m >= k)


def row_tile(L: int) -> Tuple[int, int]:
    """The row kernel's tile for rows ``L`` wide: (rows a block, stride in
    floats). The stride is L rounded up to 4 floats, plus 4 where that
    count of 16-byte chunks is even, so the 8 threads of a quarter-warp
    reading their rows 16 bytes at a time hit distinct banks. The tile
    takes ``rows * stride * 4`` bytes of shared memory."""
    chunks = (L + 3) // 4
    return ROW_TILE_ROWS[L > 64], 4 * (chunks | 1)


def bucket_topk(grid: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of ``grid`` f32[R, L]; the lowest column wins ties.

    Returns (vals f32[R, k], args i32[R, k]); rounds past a row's finite
    entries yield ``-inf`` and the sentinel column ``L``. The CUDA kernel
    takes the route :func:`kernel_route` names and raises for ``L`` above
    128 (the engine's grid is ``max(bucket_rows, top_k)`` = 64 wide by
    default, the region chain merge's ``max_chain * K1`` = 64). It takes
    a contiguous grid at any base address.
    """
    if route(grid) == "plain":
        return ref.bucket_topk_ref(grid, k)
    if grid.dtype != torch.float32 or grid.dim() != 2 \
            or not grid.is_contiguous():
        raise ValueError("grid must be a contiguous float32 [R, L]")
    R, L = grid.shape
    lib = _bucket_topk_lib()
    if L > lib.repro_bucket_topk_max_width():
        raise ValueError(f"bucket_topk: row width {L} exceeds the kernel's "
                         f"{lib.repro_bucket_topk_max_width()}")
    vals = torch.empty((R, k), dtype=torch.float32, device=grid.device)
    args = torch.empty((R, k), dtype=torch.int32, device=grid.device)
    launch_bucket_topk(grid, vals, args)
    return vals, args


def launch_bucket_topk(grid, vals, args, kroute: Optional[str] = None
                       ) -> None:
    """Launch the bucket_topk kernel into ``vals``/``args`` [R, k] on
    ``kroute`` (default :func:`kernel_route`'s), counting it. The bare
    launch under :func:`bucket_topk`, which checks ``grid`` and allocates
    the outputs."""
    (R, L), k = grid.shape, int(vals.shape[1])
    kroute = kernel_route(k) if kroute is None else kroute
    lib = _bucket_topk_lib()
    ptrs = (grid.data_ptr(), R, L, k)
    outs = (vals.data_ptr(), args.data_ptr(),
            torch.cuda.current_stream(grid.device).cuda_stream)
    if kroute == "row":
        if k > ROW_MAX_K:
            raise ValueError(f"bucket_topk: the row route takes k up to "
                             f"{ROW_MAX_K}, not {k}")
        code = lib.repro_bucket_topk_rows(*ptrs, row_kmax(k), *row_tile(L),
                                          *outs)
    elif kroute == "warp":
        code = lib.repro_bucket_topk(*ptrs, *outs)
    else:
        raise ValueError(f"bucket_topk: no route {kroute!r}")
    check_launch(code, "bucket_topk")
    LAUNCHES["bucket_topk"] += 1
    ROUTE_LAUNCHES[kroute] += 1


def region_rank(w_ab, c_ab, w_a, w_b, c_a, c_b, ok, last_tick, total_w,
                total_c, now, *, k: int,
                coefs: Tuple[float, float, float, float],
                min_pair_weight: float, min_src_weight: float,
                min_pair_count: float, half_life: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Lazy decay +) scoring, gates and per-region top-k over the region
    layout's grid.

    ``w_ab``, ``c_ab``, ``w_b``, ``c_b`` are f32[R, W] and ``ok`` bool[R, W]
    (a pure view of the store); ``w_a``, ``c_a`` f32[R] are each region's
    source marginals; ``total_w``/``total_c`` 0-d f32 tensors.
    ``half_life`` enables the exponential read-time decay of ``w_ab`` from
    ``last_tick`` (i32[R, W]) to ``now``. Returns (vals f32[R, k], args
    i32[R, k], npass i32[R]); ties go to the lowest column, exhausted
    rounds give ``-inf`` and the sentinel column W. The CUDA kernel takes
    the route :func:`kernel_route` names and reads a region row with one
    warp, at most four slots a lane, so it raises for W above 128.
    """
    grid = (w_ab, c_ab, w_b, c_b)
    if route(*grid, w_a, c_a, ok) == "plain":
        if half_life is not None:
            w_ab = decay_exp2(w_ab, last_tick, now, half_life)
        return ref.region_rank_ref(w_ab, c_ab, w_a, w_b, c_a, c_b, ok,
                                   total_w, total_c, k, coefs,
                                   min_pair_weight, min_src_weight,
                                   min_pair_count)
    R, W = w_ab.shape
    lib = _region_rank_lib()
    if W > lib.repro_region_rank_max_width():
        raise ValueError(f"region_rank: region width {W} exceeds the "
                         f"kernel's {lib.repro_region_rank_max_width()}")
    for t in grid:
        if t.dtype != torch.float32 or t.shape != (R, W) \
                or not t.is_contiguous():
            raise ValueError("region lanes must be contiguous float32 [R, W]")
    for t in (w_a, c_a):
        if t.dtype != torch.float32 or t.shape != (R,) \
                or not t.is_contiguous():
            raise ValueError("source marginals must be contiguous "
                             "float32 [R]")
    if ok.dtype != torch.bool or ok.shape != (R, W) or not ok.is_contiguous():
        raise ValueError("ok must be a contiguous bool [R, W]")
    dev = w_ab.device
    lt_ptr = None
    if half_life is not None:
        if (last_tick.dtype != torch.int32 or last_tick.shape != (R, W)
                or not last_tick.is_contiguous() or last_tick.device != dev):
            raise ValueError("last_tick must be a contiguous int32 [R, W] "
                             "on the lanes' device")
        lt_ptr = last_tick.data_ptr()
    scalars = torch.stack([
        torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())
        for x in (total_w, total_c, 0 if now is None else now)])
    vals = torch.empty((R, k), dtype=torch.float32, device=dev)
    args = torch.empty((R, k), dtype=torch.int32, device=dev)
    npass = torch.empty((R,), dtype=torch.int32, device=dev)
    launch_region_rank((w_ab, c_ab, w_a, w_b, c_a, c_b), ok, lt_ptr, scalars,
                       coefs, (min_pair_weight, min_src_weight,
                               min_pair_count), half_life, vals, args, npass)
    return vals, args, npass


def launch_region_rank(lanes, ok, lt_ptr, scalars, coefs, gates, half_life,
                       vals, args, npass, kroute: Optional[str] = None
                       ) -> None:
    """Launch the region_rank kernel into ``vals``/``args`` [R, k] and
    ``npass`` [R] on ``kroute`` (default :func:`kernel_route`'s), counting
    it.

    The bare launch under :func:`region_rank`, which checks the lanes
    (``w_ab, c_ab, w_a, w_b, c_a, c_b``) and stacks ``scalars`` (f32[3]:
    total_w, total_c, now); ``lt_ptr`` is the ``last_tick`` lane's pointer,
    or None without ``half_life``.
    """
    (R, W), k = lanes[0].shape, int(vals.shape[1])
    kroute = kernel_route(k) if kroute is None else kroute
    lib = _region_rank_lib()
    c0, c1, c2, c3 = (float(c) for c in coefs)
    head = ([t.data_ptr() for t in lanes]
            + [ok.data_ptr(), lt_ptr, scalars.data_ptr(), c0, c1, c2, c3]
            + [float(g) for g in gates]
            + [0.0 if half_life is None else float(half_life), R, W, k])
    outs = (vals.data_ptr(), args.data_ptr(), npass.data_ptr(),
            torch.cuda.current_stream(vals.device).cuda_stream)
    if kroute == "row":
        if k > ROW_MAX_K:
            raise ValueError(f"region_rank: the row route takes k up to "
                             f"{ROW_MAX_K}, not {k}")
        code = lib.repro_region_rank_rows(*head, row_kmax(k), *outs)
    elif kroute == "warp":
        code = lib.repro_region_rank(*head, *outs)
    else:
        raise ValueError(f"region_rank: no route {kroute!r}")
    check_launch(code, "region_rank")
    LAUNCHES["region_rank"] += 1
    REGION_ROUTE_LAUNCHES[kroute] += 1

"""The autotuner: per-op timings of kernels and their twins.

Port of the JAX package's ``launch/autotune.py``. There the tuner measures
each hot path's Pallas kernel against its jnp twin and routes the engine
through the winner, and picks the ingest fusion width. In the port the
device routes (``core/plan.py``): on CUDA every hot path launches its
hand-written kernel, on the CPU it runs its plain torch twin, and the
engine ingests one quantum slice a call. So the tuner here chooses
nothing; it measures and records:

  * on CUDA times each of the layout's kernels and its twin on the card
    (both recorded in ``timings_us``) and writes ``"kernel"`` for every op
    it measured. A kernel candidate that raises makes :func:`measure_plan`
    raise: no route may hide a kernel. An op whose twin beats its kernel
    still says ``"kernel"``; it is listed under ``twin_faster`` in the
    cache record and printed;
  * on the CPU times the twins only and writes ``"jnp"``;
  * leaves the knobs at their defaults (``ingest_chunk`` 0,
    ``score_block_rows`` 16), which no port dispatch reads.

Plans are cached on disk, one JSON per :func:`~repro_torch.core.plan.
shape_class` (device type and name, log2 capacities, layout, region
width), under ``$REPRO_TORCH_AUTOTUNE_CACHE`` (default
``~/.cache/repro-torch-autotune``): the JAX package's cache is another
directory, since a CPU shape class can be the same string in both. A
cache hit returns the stored plan and measures nothing.

Synthetic inputs come from explicit ``torch.Generator``s at the shapes the
JAX tuner builds; only timings depend on them. :func:`hot_path_traffic`
returns the JAX tuner's analytic bytes and flops, number for number, for
``roofline.hot_path_roofline``.

    from repro_torch.launch.autotune import tune
    plan = tune(EngineConfig(...))                  # on the card
    plan = tune(EngineConfig(...), device="cpu")
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core import stores
from ..core.plan import (HOT_PATH_OPS, JNP, KERNEL, LAYOUT_OPS, TunedPlan,
                         device_route, shape_class)
from ..kernels import ops as kops
from ..kernels import ref

__all__ = ["tune", "measure_plan", "cache_dir",
           "cache_path", "hot_path_traffic", "TunedPlan", "shape_class"]

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1


def cache_dir(override: Optional[str] = None) -> Path:
    if override is not None:
        return Path(override)
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-torch-autotune"


def cache_path(cfg, device="cuda", override: Optional[str] = None) -> Path:
    return cache_dir(override) / f"{shape_class(cfg, device)}.json"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn: Callable, repeats: int, device: torch.device) -> float:
    """Best-of-``repeats`` wall time of ``fn()`` in µs, the card
    synchronized before and after each call, after one warm-up call (which
    absorbs a kernel's first-use build, never timed)."""
    def once() -> float:
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        return time.perf_counter() - t0
    once()
    return min(once() for _ in range(max(repeats, 1))) * 1e6


# ---------------------------------------------------------------------------
# synthetic per-op workloads (shapes from cfg; content random but fixed)
# ---------------------------------------------------------------------------

def _gen(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _u30(g, shape, device):
    """int32 values in [1, 2^30): live u32 keys as the stores' int32 views."""
    return torch.randint(1, 1 << 30, shape, generator=g, device=device,
                         dtype=torch.int32)


def _gates(rk) -> dict:
    return dict(coefs=rk.coefs, min_pair_weight=rk.min_pair_weight,
                min_src_weight=rk.min_src_weight,
                min_pair_count=rk.min_pair_count)


def _score_gate_pair(cfg, g, device):
    """(kernel_fn, twin_fn) of the fused score + gate pass over C lanes."""
    C = cfg.cooc_capacity
    u = lambda: _uniform(g, (C,), 0.0, 4.0, device)
    w_ab, w_a, w_b = u(), u() + 1.0, u() + 1.0
    c_ab = torch.ceil(u())
    c_a, c_b = c_ab + torch.ceil(u()), c_ab + torch.ceil(u())
    ok = torch.rand((C,), generator=g, device=device) < 0.7
    tw, tc = w_a.sum(), c_a.sum()
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b, ok, tw, tc)
    kw = _gates(cfg.rank)
    return (lambda: kops.score_gate(*lanes, **kw),
            lambda: ref.score_gate_ref(*lanes, **kw))


def _bucket_topk_pair(cfg, g, device):
    rk = cfg.rank
    C, Q = cfg.cooc_capacity, cfg.query_capacity
    M = min(C, max(rk.top_k, int(C * min(rk.seg_arena_frac, 1.0))))
    R = min(Q, M, max(rk.source_cap(Q), 1))
    L = max(rk.bucket_rows, rk.top_k)
    grid = torch.where(torch.rand((R, L), generator=g, device=device) < 0.8,
                       torch.rand((R, L), generator=g, device=device),
                       torch.tensor(-torch.inf, device=device))
    K = rk.top_k
    return (lambda: kops.bucket_topk(grid, K),
            lambda: ref.bucket_topk_ref(grid, K))


def _region_rank_pair(cfg, g, device):
    rk = cfg.rank
    W = cfg.region_w
    R = cfg.cooc_capacity // W
    u = lambda shape: _uniform(g, shape, 0.0, 4.0, device)
    w_ab, w_b = u((R, W)), u((R, W)) + 1.0
    w_a = u((R,)) + 1.0
    c_ab = torch.ceil(u((R, W)))
    c_a, c_b = torch.ceil(u((R,))) + 1.0, c_ab + 1.0
    ok = torch.rand((R, W), generator=g, device=device) < 0.7
    tw, tc = w_a.sum(), c_a.sum()
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b, ok, tw, tc)
    K1 = min(rk.top_k, W)
    kw = _gates(rk)
    return (lambda: kops.region_rank(*lanes, k=K1, **kw),
            lambda: ref.region_rank_ref(*lanes, K1, kw["coefs"],
                                        kw["min_pair_weight"],
                                        kw["min_src_weight"],
                                        kw["min_pair_count"]))


def _chain_find_pair(cfg, g, device):
    W = cfg.region_w
    R = cfg.cooc_capacity // W
    MC = cfg.region_chain
    B = min(4096, max(256, cfg.ingest_quantum or 1024))
    khi, klo = _u30(g, (R, W), device), _u30(g, (R, W), device)
    regs = torch.randint(0, R, (B, MC), generator=g, device=device,
                         dtype=torch.int32)
    depth = torch.arange(MC, device=device)[None, :]
    regs = torch.where(depth < 2, regs, torch.full_like(regs, -1))  # short
    pick_r = regs[:, 0].long()
    pick_w = torch.randint(0, W, (B,), generator=g, device=device)
    hit = torch.rand((B,), generator=g, device=device) < 0.5   # ~half hits
    one = torch.ones((B,), dtype=torch.int32, device=device)
    dhi = torch.where(hit, khi[pick_r, pick_w], one)
    dlo = torch.where(hit, klo[pick_r, pick_w], one)
    act = torch.ones((B,), dtype=torch.bool, device=device)
    args = (khi, klo, regs, dhi, dlo, act)
    return (lambda: kops.chain_find(*args),
            lambda: ref.chain_find_ref(*args))


def _decay_prune_pair(cfg, g, device):
    C = cfg.cooc_capacity
    tab = stores.make_table(C, {"weight": torch.float32,
                                "count": torch.float32,
                                "last_tick": torch.int32}, device)
    live = torch.rand((C,), generator=g, device=device) < 0.5
    kh = torch.where(live, _u30(g, (C,), device) | 1,
                     torch.zeros((C,), dtype=torch.int32, device=device))
    w = torch.where(live, _uniform(g, (C,), 0.0, 4.0, device),
                    torch.zeros((C,), device=device))
    tab = tab._replace(key_hi=kh, key_lo=kh.clone(), lanes={
        "weight": w, "count": torch.ceil(w),
        "last_tick": torch.zeros((C,), dtype=torch.int32, device=device)})
    dt = max(cfg.decay_every, 1)
    dcfg = cfg.decay
    f = dcfg.factor(dt)
    return (lambda: kops.decay_prune_table(tab, dt, cfg=dcfg,
                                           weight_lanes=("weight",)),
            lambda: ref.decay_prune_multi_ref(
                tab.key_hi, tab.key_lo, (tab.lanes["weight"],),
                (tab.lanes["count"], tab.lanes["last_tick"]), f,
                dcfg.prune_threshold))


_PAIRS = {"score_gate": (_score_gate_pair, 1),
          "bucket_topk": (_bucket_topk_pair, 2),
          "region_rank": (_region_rank_pair, 3),
          "chain_find": (_chain_find_pair, 4),
          "decay_prune": (_decay_prune_pair, 5)}


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def measure_plan(cfg, *, device="cuda", repeats: int = 3
                 ) -> Tuple[TunedPlan, Dict[str, float]]:
    """Time every hot path of ``cfg``'s layout on ``device`` (CUDA unless
    named) and build the plan. Returns ``(plan, timings_us)``: on CUDA
    ``"<op>:kernel"`` and ``"<op>:jnp"`` (the twin) for each op, on the
    CPU the twins only. A kernel that raises propagates."""
    device = stores.resolve_device(device)
    route = device_route(device)
    timings: Dict[str, float] = {}
    choices = {op: JNP for op in HOT_PATH_OPS}
    for op in LAYOUT_OPS[cfg.cooc_layout]:
        build, seed = _PAIRS[op]
        kfn, jfn = build(cfg, _gen(device, seed), device)
        if route == KERNEL:
            timings[f"{op}:kernel"] = _time_us(kfn, repeats, device)
        timings[f"{op}:jnp"] = _time_us(jfn, repeats, device)
        choices[op] = route
        del kfn, jfn

    plan = TunedPlan(**choices, backend=device.type,
                     shape_class=shape_class(cfg, device))
    return plan, timings


def twin_faster(timings: Dict[str, float]) -> Dict[str, Tuple[float, float]]:
    """op -> (kernel µs, twin µs) for every op whose twin beat its kernel."""
    out = {}
    for key, t in timings.items():
        if key.endswith(":kernel"):
            op = key.split(":")[0]
            tj = timings.get(f"{op}:jnp")
            if tj is not None and tj < t:
                out[op] = (t, tj)
    return out


def tune(cfg, *, device="cuda", cache: Optional[str] = None,
         force: bool = False, repeats: int = 3) -> TunedPlan:
    """The tuned plan for ``cfg`` on ``device``: from the shape-class disk
    cache when present (nothing measured), else measured and cached."""
    device = stores.resolve_device(device)
    path = cache_path(cfg, device, cache)
    if not force and path.exists():
        try:
            rec = json.loads(path.read_text())
            if rec.get("version") == CACHE_VERSION:
                return TunedPlan.from_json(rec["plan"])
        except (ValueError, KeyError):
            pass                               # corrupt cache: re-measure
    plan, timings = measure_plan(cfg, device=device, repeats=repeats)
    slower = twin_faster(timings)
    if slower:
        print(f"[autotune] {plan.shape_class}: twin faster than its kernel "
              f"(µs kernel, twin): {slower}; the plan keeps 'kernel'",
              flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(
        {"version": CACHE_VERSION, "shape_class": plan.shape_class,
         "backend": device.type, "plan": plan.to_json(),
         "timings_us": timings, "twin_faster": sorted(slower)},
        indent=2, sort_keys=True))
    os.replace(tmp, path)
    return plan


# ---------------------------------------------------------------------------
# roofline hooks: per-op HBM traffic models for the tuned hot paths
# ---------------------------------------------------------------------------

def hot_path_traffic(cfg) -> Dict[str, Dict[str, float]]:
    """The JAX tuner's analytic bytes and flops per hot-path call, for
    ``roofline.hot_path_roofline`` rows (table sweeps: bytes dominate;
    flops are a lanes-linear estimate)."""
    C = float(cfg.cooc_capacity)
    rk = cfg.rank
    out: Dict[str, Dict[str, float]] = {}
    if not cfg.region_cooc:
        # 7 f32 input lanes read + 1 f32 score lane written
        out["score_gate"] = {"bytes": 8 * 4 * C, "flops": 60 * C}
        M = min(C, max(rk.top_k, int(C * min(rk.seg_arena_frac, 1.0))))
        R = min(cfg.query_capacity, M)
        L = max(rk.bucket_rows, rk.top_k)
        out["bucket_topk"] = {
            "bytes": 4.0 * R * L + 8.0 * R * rk.top_k,
            "flops": 3.0 * R * L * rk.top_k}
    else:
        W = float(cfg.region_w)
        out["region_rank"] = {
            "bytes": 8 * 4 * C + 8.0 * (C / W) * min(rk.top_k, int(W)),
            "flops": 60 * C}
        B = float(min(4096, max(256, cfg.ingest_quantum or 1024)))
        out["chain_find"] = {"bytes": B * 2 * (2 * 4 * W + 4),
                             "flops": B * 2 * 3 * W}
    # keys (2 u32) + 3 lanes read and written
    out["decay_prune"] = {"bytes": 2 * (2 + 3) * 4 * C, "flops": 6 * C}
    return out

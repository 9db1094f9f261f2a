#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

  1. card and build — the card's name and power limit (nvidia-smi), then
     every CUDA kernel built from ``src/repro_torch/kernels/csrc``;
  2. kernels at main-path shapes — each kernel against its plain torch
     version on the card (random inputs from a numpy seed): max error; the
     kernel's own time (its bare launch into preallocated outputs), the
     wrapper's, the plain version's and the library call's time (CUDA
     events, median of 20 after warm-up); and the least time the
     card could take (HBM bytes at 3.35 TB/s or operations at 67 TFLOP/s
     f32, whichever is larger);
  3. the engine on the card against the engine on the CPU at a small size
     (state under the parity contract, suggestions);
  4. the main path at deployment scale — ``SearchAssistanceEngine.step``
     for 17 ticks (4 decay sweeps, 2 rank cycles), with every kernel's
     launch count read around that run; no drops, suggestions out;
  5. determinism — the same stream twice gives bit-identical state.

The second-to-last line is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32, outside the tensor cores
SEED = 0
# ~1 ms of device sleep at the H100's clock: queued before a timed call so
# the host's launch work hides under it and the events time the device.
SLEEP_CYCLES = 2_000_000


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device span of ``fn()`` in ms over ``reps`` calls (CUDA
    events), each queued behind a device sleep so host launch work is
    hidden."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels at main-path shapes.
# ---------------------------------------------------------------------------

def _u32_lane(rng, n, dead, dev):
    import numpy as np
    import torch
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    x[dead] = 0
    return torch.from_numpy(x.view(np.int32)).to(dev)


def check_decay_prune(C: int, n_aux: int, dev):
    """decay_prune_multi at a store of capacity C (1 weight lane, n_aux aux
    lanes), held bit-for-bit against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decay_prune import decay_prune_multi, launch
    rng = np.random.default_rng(SEED + C)
    dead = rng.random(C) < 0.4
    kh, kl = _u32_lane(rng, C, dead, dev), _u32_lane(rng, C, dead, dev)
    w = torch.from_numpy((rng.random(C) * 0.2).astype(np.float32)).to(dev)
    aux = [torch.from_numpy(np.floor(rng.random(C) * 9).astype(np.float32)).to(dev),
           torch.from_numpy(rng.integers(0, 17, C).astype(np.int32)).to(dev)]
    aux += [_u32_lane(rng, C, dead, dev) for _ in range(n_aux - 2)]
    f = float(2.0 ** (-4 / 36.0))
    got = decay_prune_multi(kh, kl, [w], aux, f, 0.05)
    exp = ref.decay_prune_multi_ref(kh, kl, [w], aux, torch.tensor(f), 0.05)
    for g, e in zip((got[0], got[1], *got[2], *got[3]),
                    (exp[0], exp[1], *exp[2], *exp[3])):
        if not torch.equal(g.view(torch.int32), e.view(torch.int32)):
            raise AssertionError(f"decay_prune_multi C={C}: lanes differ")
    err = float((got[2][0] - exp[2][0]).abs().max())
    outs = [torch.empty_like(t) for t in (kh, kl, w)]
    a_out = [torch.empty_like(a) for a in aux]
    ms = time_ms(lambda: launch(kh, kl, w, aux, *outs, a_out, f, 0.05))
    wrapper_ms = time_ms(lambda: decay_prune_multi(kh, kl, [w], aux, f, 0.05))
    plain_ms = time_ms(lambda: ref.decay_prune_multi_ref(
        kh, kl, [w], aux, torch.tensor(f), 0.05))
    lanes = 2 + 1 + n_aux
    b_ms, b_by = bound(C * lanes * 4 * 2, C * 2)
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _score_inputs(C, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    mk = lambda s: (rng.random(C) * s).astype(np.float32)
    w_ab, c_ab = mk(5), np.floor(mk(20))
    w_a, w_b = mk(50), mk(50)
    c_a = np.maximum(c_ab, np.floor(mk(100)))
    c_b = np.maximum(c_ab, np.floor(mk(100)))
    lanes = [torch.from_numpy(x).to(dev) for x in (w_ab, c_ab, w_a, w_b, c_a, c_b)]
    ok = torch.from_numpy(rng.random(C) < 0.8).to(dev)
    lt = torch.from_numpy(rng.integers(0, 17, C).astype(np.int32)).to(dev)
    sc = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (float(C) * 2.0, float(C) * 4.0, 17.0)]
    return lanes, ok, lt, sc


SCORE_OPS_PER_SLOT = 60   # f32 adds/muls/compares/divides + 9 libm calls


def check_score_gate(C: int, dev):
    """score_gate with and without in-kernel decay, against the plain
    version at rtol 1e-5, atol 1e-6 where both are finite; gate flips
    within one ulp of min_pair_weight are counted and printed."""
    import torch
    from repro_torch.core.ranking import RankConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_select import launch_score_gate, score_gate
    rc = RankConfig()
    gates = dict(min_pair_weight=rc.min_pair_weight,
                 min_src_weight=rc.min_src_weight,
                 min_pair_count=rc.min_pair_count)
    lanes, ok, lt, sc = _score_inputs(C, dev)
    err = 0.0
    for half_life in (None, 36.0):
        got = score_gate(*lanes, ok, lt, *sc, coefs=rc.coefs,
                         half_life=half_life, **gates)
        w_eff = lanes[0]
        if half_life is not None:
            dt = torch.clamp_min(sc[2] - lt.float(), 0.0)
            w_eff = w_eff * torch.exp2(-dt / half_life)
        exp = ref.score_gate_ref(w_eff, *lanes[1:], ok, sc[0], sc[1],
                                 rc.coefs, **gates)
        both = torch.isfinite(got) & torch.isfinite(exp)
        torch.testing.assert_close(got[both], exp[both], rtol=1e-5, atol=1e-6)
        flips = torch.isneginf(got) != torch.isneginf(exp)
        near = (w_eff - rc.min_pair_weight).abs() <= 2.0 ** -23 * 0.25
        n_flips = int(flips.sum())
        if n_flips != int((flips & near).sum()):
            raise AssertionError("score_gate: gate masks differ away from "
                                 "the min_pair_weight boundary")
        e = float((got[both] - exp[both]).abs().max())
        err = max(err, e)
        log(f"  score_gate half_life={half_life}: max_abs_err={e!r} "
            f"gate flips within 1 ulp of min_pair_weight={n_flips}")
    kw = dict(coefs=rc.coefs, half_life=None, **gates)
    scalars, out = torch.stack(sc), torch.empty_like(lanes[0])
    ms = time_ms(lambda: launch_score_gate(
        lanes, ok, None, scalars, rc.coefs, tuple(gates.values()), None, out))
    wrapper_ms = time_ms(lambda: score_gate(*lanes, ok, lt, *sc, **kw))
    plain_ms = time_ms(lambda: ref.score_gate_ref(
        *lanes, ok, sc[0], sc[1], rc.coefs, **gates))
    b_ms, b_by = bound(C * (6 * 4 + 1 + 4), C * SCORE_OPS_PER_SLOT)
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_bucket_topk(R: int, L: int, K: int, dev):
    """bucket_topk against the plain version: vals equal, args equal where
    vals > -inf; torch.topk timed beside it as the library yardstick."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_select import bucket_topk, launch_bucket_topk
    rng = np.random.default_rng(SEED + 2)
    g = np.floor(rng.random((R, L), dtype=np.float32) * 64)     # many ties
    g[rng.random((R, L)) < 0.5] = -np.inf
    grid = torch.from_numpy(g).to(dev)
    del g
    vals, args = bucket_topk(grid, K)
    ev, ea = ref.bucket_topk_ref(grid, K)
    fin = ev > -torch.inf
    if not (torch.equal(vals, ev) and torch.equal(args[fin], ea[fin])):
        raise AssertionError("bucket_topk differs from the plain version")
    err = float((vals[fin] - ev[fin]).abs().max())
    bv, ba = torch.empty_like(vals), torch.empty_like(args)
    ms = time_ms(lambda: launch_bucket_topk(grid, bv, ba))
    wrapper_ms = time_ms(lambda: bucket_topk(grid, K))
    plain_ms = time_ms(lambda: ref.bucket_topk_ref(grid, K))
    library_ms = time_ms(lambda: torch.topk(grid, K, dim=1))
    b_ms, b_by = bound(R * L * 4 + R * K * 8, R * L * K)
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


# ---------------------------------------------------------------------------
# Phases 3-5: the engine.
# ---------------------------------------------------------------------------

def small_parity(dev) -> None:
    """The engine on the card against the engine on the CPU, on the
    ``tests/test_engine.py`` stream and configuration (9 ticks)."""
    import numpy as np
    from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
    from repro_torch.data.stream import StreamConfig, SyntheticStream
    cfg = EngineConfig(query_capacity=1 << 12, cooc_capacity=1 << 14,
                       session_capacity=1 << 11, session_window=4,
                       decay_every=4, rank_every=8)
    engines = []
    for device in (dev, "cpu"):
        stream = SyntheticStream(StreamConfig(
            vocab_size=256, n_users=150, queries_per_tick=128,
            tweets_per_tick=16, tweet_words=4, tweet_grams=6), seed=11)
        eng = SearchAssistanceEngine(cfg, device=device)
        for t in range(9):
            eng.step(*stream.gen_tick(t))
        engines.append(eng)
    a, b = (e.state_arrays() for e in engines)
    n_exact = 0
    for i in range(len(a)):
        x, y = a[f"leaf_{i}"], b[f"leaf_{i}"]
        if x.dtype == np.float32:
            np.testing.assert_allclose(x, y, rtol=2e-3, err_msg=f"leaf_{i}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"leaf_{i}")
        n_exact += x.tobytes() == y.tobytes()
    sa, sb = engines[0].suggestions, engines[1].suggestions
    if set(sa) != set(sb) or not sa:
        raise AssertionError("suggestion sources differ between card and CPU")
    agree = 0
    for f in sa:
        np.testing.assert_allclose([s for _, s in sa[f][:3]],
                                   [s for _, s in sb[f][:3]],
                                   rtol=5e-3, atol=1e-4)
        agree += [d for d, _ in sa[f][:3]] == [d for d, _ in sb[f][:3]]
    if agree < 0.95 * len(sa):
        raise AssertionError(f"top-3 agreement {agree}/{len(sa)}")
    log(f"  card vs CPU: {n_exact}/{len(a)} leaves bit-identical, keys and "
        f"slots exact, {len(sa)} sources, top-3 identity agreement "
        f"{agree}/{len(sa)}")


def deployment_config():
    from repro_torch.core.engine import EngineConfig
    from repro_torch.data.stream import StreamConfig
    return (EngineConfig(query_capacity=1 << 22, cooc_capacity=1 << 24,
                         session_capacity=1 << 20, decay_every=4,
                         rank_every=8),
            StreamConfig(vocab_size=65536, n_users=200000,
                         queries_per_tick=16384, tweets_per_tick=2048))


def main_path(dev, ticks):
    """Drive SearchAssistanceEngine.step over the pre-generated ticks with
    the launch counts set to 0 just before and read just after."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import engine as te
    cfg, scfg = deployment_config()
    eng = te.SearchAssistanceEngine(cfg, device=dev)
    cycle_ms = {"decay": [], "rank": []}

    def timed(kind, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            cycle_ms[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    decay_cycle = te.decay_cycle
    te.decay_cycle = timed("decay", decay_cycle)
    eng.run_rank_cycle = timed("rank", eng.run_rank_cycle)
    step_ms, results = [], []
    torch.cuda.synchronize()
    tk.reset_launches()
    try:
        for events, tweets in ticks:
            t0 = time.perf_counter()
            res = eng.step(events, tweets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if res:
                results.append(res)
                log(f"  tick {res['tick']}: rank cycle -> {res['n_suggest']} "
                    f"queries with suggestions ({res['n_rows']} rows, "
                    f"{res['n_overflow']} overflow)")
    finally:
        te.decay_cycle = decay_cycle
    launches = dict(tk.LAUNCHES)
    return eng, step_ms, cycle_ms, results, launches


def _profiled(label, fn) -> None:
    """Run ``fn`` under torch.profiler: wall time, summed device kernel
    time, device busy share, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log(f"  profiled {label}: no device time recorded (busy share not "
            f"measured)")
        return
    busy_ms = sum(r[1] for r in rows)
    log(f"  profiled {label}: wall {wall_ms:.3f} ms, device kernels "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% busy), "
        f"{sum(r[2] for r in rows)} kernel launches")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"    {ms:9.3f} ms  x{n:<5d} {key[:90]}")


def profile_tick(eng, tick) -> None:
    """One more ingest-only tick, then one rank cycle, under the profiler."""
    _profiled("ingest tick", lambda: eng.step(*tick))
    _profiled("rank cycle", eng.run_rank_cycle)


def state_bits_equal(a, b) -> bool:
    """``state_arrays()`` of two engines, compared byte for byte."""
    sa, sb = a.state_arrays(), b.state_arrays()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and sa[k].tobytes() == sb[k].tobytes()
        for k in sa)


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as tk
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    t_start = time.perf_counter()

    # ---- 1. card and build ----
    log(f"[1] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    paths = build.build_all()
    for stem in paths:
        build.load(stem)
    log(f"  built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for stem in sorted(paths):
        for line in build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")

    # ---- 2. kernels at main-path shapes ----
    cfg, _ = deployment_config()
    C, Q = cfg.cooc_capacity, cfg.query_capacity
    R = min(Q, int(C * cfg.rank.seg_arena_frac))
    L, K = max(cfg.rank.bucket_rows, cfg.rank.top_k), cfg.rank.top_k
    log(f"[2] kernels vs plain versions: cooc C={C}, qstore C={Q}, "
        f"grid {R}x{L}, K={K}")
    rows = {}
    rows["decay_prune_multi"] = check_decay_prune(C, 6, dev)
    q_row = check_decay_prune(Q, 2, dev)
    log(f"  decay_prune_multi qstore C={Q}: {json.dumps(q_row)}")
    rows["score_gate"] = check_score_gate(C, dev)
    rows["bucket_topk"] = check_bucket_topk(R, L, K, dev)
    for name, row in rows.items():
        log(f"  {name} at its main-path shape: {json.dumps(row)}")
    log("kernels " + " ".join(f"{n}=ok" for n in rows))
    torch.cuda.empty_cache()

    # ---- 3. card vs CPU at a small size ----
    log("[3] engine on the card vs engine on the CPU (test_engine stream)")
    small_parity(dev)

    # ---- 4. main path at deployment scale ----
    from repro_torch.data.stream import SyntheticStream
    cfg, scfg = deployment_config()
    n_ticks = 17
    t0 = time.perf_counter()
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(n_ticks)]
    extra_tick = stream.gen_tick(n_ticks)
    log(f"[4] main path: {n_ticks} ticks of {scfg.queries_per_tick} queries "
        f"+ {scfg.tweets_per_tick} tweets; stream generated in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    eng, step_ms, cycle_ms, results, launches = main_path(dev, ticks)
    st = eng.state
    drops = {n: int(getattr(st, n).n_dropped)
             for n in ("qstore", "cooc", "sessions")}
    live_q, live_c = int(st.qstore.live_count()), int(st.cooc.live_count())
    log(f"  launches on the main path: {launches}")
    log(f"  n_dropped {drops}; live qstore {live_q}/{Q}, cooc {live_c}/{C}")
    if any(drops.values()):
        raise AssertionError(f"dropped updates at deployment scale: {drops}")
    if len(results) != 2 or results[-1]["n_suggest"] <= 0:
        raise AssertionError(f"rank cycles: {results}")
    missing = [n for n in tk.KERNELS if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    if eng.n_decay_cycles != 4:
        raise AssertionError(f"decay cycles: {eng.n_decay_cycles}")
    ev_per_tick = scfg.queries_per_tick + scfg.tweets_per_tick
    plain = [m for i, m in enumerate(step_ms)
             if i % cfg.decay_every and i % cfg.rank_every]
    main = {
        "ms_per_tick_mean": statistics.mean(step_ms),
        "ms_per_tick_median": statistics.median(step_ms),
        "ms_per_ingest_only_tick_median": statistics.median(plain),
        "events_per_s": ev_per_tick * len(step_ms) / (sum(step_ms) / 1e3),
        "decay_cycle_ms": cycle_ms["decay"],
        "rank_cycle_ms": cycle_ms["rank"],
        "step_ms": step_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log("  main path: " + json.dumps(main))
    profile_tick(eng, extra_tick)
    for i in range(5):
        q = stream.vocab[i]
        sugg = eng.suggest_fp(stream.tok.query_fp(q), k=4)
        log(f"  {q!r:24s} -> "
            f"{[(stream.tok.text(d), round(s, 3)) for d, s in sugg]}")
    del eng, st
    torch.cuda.empty_cache()

    # ---- 5. determinism ----
    from repro_torch.core.engine import SearchAssistanceEngine
    runs = []
    for _ in range(2):
        e = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks[:5]:
            e.step(events, tweets)
        runs.append(e)
    if not state_bits_equal(*runs):
        raise AssertionError("two runs of the same stream differ")
    log("[5] determinism: two 5-tick runs (one decay sweep) bit-identical")
    del runs

    sources = {"decay_prune_multi": ("decay_prune.cu", "decay_prune.py:85"),
               "score_gate": ("score_gate.cu", "topk_select.py:78"),
               "bucket_topk": ("bucket_topk.cu", "topk_select.py:150")}
    record = {"kernels": [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{sources[n][0]}",
         "replaces": f"src/repro/kernels/{sources[n][1]}",
         "launches": launches[n],
         **{k: v for k, v in rows[n].items() if k != "wrapper_ms"}}
        for n in tk.KERNELS]}
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

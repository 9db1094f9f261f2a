#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-region-only [--root DIR]
    python3 chip_smoke.py --profile-hash-only [--root DIR]

Phases, each of which must pass:

  1. card and build — the card's name and power limit (nvidia-smi), then
     every CUDA kernel built from ``src/repro_torch/kernels/csrc``;
  2. kernels at main-path shapes — each kernel against its plain torch
     version on the card (random inputs from a numpy seed; ``chain_find``
     on the region store and the largest pair batch of an untimed replay
     of the phase-4 region run's ticks): max error; the kernel's own time
     (its bare launch into preallocated outputs), the wrapper's, the plain
     version's and the library call's time (CUDA events, median of 20
     after warm-up); and the least time the card could take (HBM bytes
     at 3.35 TB/s or operations at 67 TFLOP/s f32, whichever is larger;
     for ``flash_attention`` its in-band FLOPs at the 989 TFLOP/s bf16
     tensor-core peak and its exponentials at the SFU rate).
     ``edit_distance`` runs on the largest pair batch of an untimed run of
     the phase-4 spelling job, on both kernel routes with the same pairs
     (the job's first_char_cost 1.5 on the half-unit DPX route, 1.3 on
     the f32 route; each bit-equal to the plain version, its ms, % of
     bound, cells/us and ``-Xptxas -v`` lines printed; the half-unit route
     must be the faster). ``bucket_topk`` runs on both kernel routes (the
     wrapper's row route, one thread a row, and the warp route forced
     through its bare launch) with the same grid, each equal to the plain
     version in values and every column: a synthetic 4,194,304 x 64 grid
     (K 8, half -inf, heavy ties; ms, % of bound, rows/us and
     ``-Xptxas -v`` lines printed; the row route must be the faster), and
     the main paths' own grids at their last rank cycle from untimed
     replays of their ticks (the hash bucket grid, with the rows that hold
     a finite value counted, and the region chain merge's candidates).
     ``chain_find`` prints its batch's active share and the 32-row groups
     with no active row, its route, rows a warp, time, share of the bound,
     the other load route's time (forced), the time at each rows-a-warp
     and ``-Xptxas -v`` lines, then the same times on the run's other
     batch size. ``region_rank`` runs on both kernel routes (the wrapper's
     row route, gate first, and the warp route forced through its bare
     launch), each held against the plain version, under both decay
     policies: on a synthetic 131,072 x 128 grid (~71% of slots pass; the
     row route must be the faster), with its ``-Xptxas -v`` lines and
     static SASS counts beside assoc_score's; and on the region path's own
     grid of its last rank cycle (an untimed replay). Both grids are timed
     against the bytes that grid needs and against a yardstick that reads
     every slot. ``scripts/score_rate.py`` measures the score floor, the
     card's time for the scoring chain alone a slot (its run that scores
     less its run that only makes the inputs), and every scoring
     kernel's time is also set beside the floor times the slots it scored.
     ``score_gate`` (both decay policies) and ``assoc_score`` run on
     synthetic 2^24 lanes (~71% of slots pass) and on the lanes the hash
     path's last rank cycle gave ``score_gate`` (an untimed replay; ~1.4%
     live), each bit-equal to its plain version (score_gate wherever the
     gates agree; the lazy gate's flips within 1 ulp of min_pair_weight
     counted) through the wrapper and its bare launch, on the lanes and on
     copies one element off 16-byte alignment (the 4-byte route); each
     route timed with its pass share, the bytes those inputs need,
     the 29 B (28 B) a slot yardstick, ``-Xptxas -v`` lines and static
     SASS counts.
     ``flash_attention`` runs on layer 0's q/k/v from
     the phase-6 scoring forward (bf16, B 4, T 8192; the twin row by row),
     plus an f32 case at T 2048; its library column is SDPA with the band
     as mask, and the kernels SDPA ran are printed; the bf16 kernel (tensor
     cores) must beat that SDPA call, and its % of bound, TFLOP/s and
     ``-Xptxas -v`` lines are printed;
  3. the engine on the card against the engine on the CPU at a small size
     (state under the parity contract, suggestions), under both cooc
     layouts (hash: sweep policy; region: sweep and lazy policies); the
     spelling job and the count-min sketch on the card against the CPU
     (the small engine's qstore plus planted misspellings); the LM's
     danube, granite and qwen3 SMOKE models (f32) on the card against the
     CPU: forward, prefill and 4 decode steps;
  4. the main paths at deployment scale — ``SearchAssistanceEngine.step``
     for 17 ticks (4 decay sweeps, 2 rank cycles), once with the hash cooc
     layout and once with the region layout, each with its kernels'
     launch counts set to 0 just before and read just after (every
     ``bucket_topk`` launch on its row route); suggestions
     out, no drops on the hash path (region drops are printed), every
     ``score_gate`` launch on its 16-byte route. After the
     hash path, the spelling job over its 17-tick qstore, as the serving
     loop runs it (export, join_fp, tok.text, ``spelling_cycle``), with
     ``edit_distance``'s launches counted the same way (all on the
     half-unit route): sources, filtered pairs, wall time, corrections,
     peak memory, the stream's planted misspellings that are live and
     corrected to their true form; then 256 sources re-solved over all
     candidates with the plain version;
  5. determinism — the same stream twice gives bit-identical state, under
     each layout, the spelling job twice gives the same corrections in
     the same order, and two scoring forwards give bit-identical logits;
  6. the LM serving path — h2o-danube-1.8b at its published widths and
     depth, bf16, random weights from a seed: the scoring forward over 4
     requests of 8192 tokens (24 ``flash_attention`` launches, counts set
     to 0 just before and read just after; wall ms, tokens/s, peak
     memory); prefill of the same prompts into ring caches and 16 greedy
     decode steps (ms, peak memory, flash launches: 0); one kernel forward
     over prompt + decoded tokens (T 8208) whose logits must match the
     prefill's last chunk and every decode step; then the model in f32
     (TF32 off), B 1: prefill and 4 decode steps against the kernel
     forward at a bound a bf16 computation fails;
  7. crash recovery at deployment scale, under the hash and then the
     region layout (the phase-4 configuration and stream, seed 0): 21
     ticks, each appended to a ``FirehoseLogWriter`` (4 ticks a segment)
     before ``step``, ``save_snapshot`` into a ``CheckpointManager``
     (``full_interval=2``) at the rank cycles of ticks 8 and 16 (a full,
     then a delta); the state after tick 19 kept as the reference (host
     copies); tick 20 appended and torn by ``kill_writer_mid_segment``;
     then ``recover_engine`` from the newest chain (3 ticks replayed) and
     from the full alone (11 ticks), each bit for bit against the
     reference, leaf for leaf, its handoff rank cycle's suggestions equal
     to a rank cycle on the reference. Printed per layout: snapshot bytes
     (raw and on disk), the save split (device-to-host copy,
     ``diff_leading_rows``, ``savez``, raw sha256, zlib, file sha256,
     write and fsync) against the 80-s rank period, the restore split
     (read, sha256, zlib, raw sha256, npz load, delta apply, host-to-device
     copy), replay ms a tick and its multiple of real time (10-s ticks),
     time to fresh (restore + replay + handoff rank), peak device memory
     and the kernels' launches on the recovery path (counts set to 0
     before each recovery and read after; each of the layout's kernels
     must launch). Then ``repro_torch.breaking_news`` on the card: the
     related terms must surface within 10 sim-minutes and survive the
     crash.

The second-to-last line is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.

``--profile-region-only`` runs none of the phases: it drives the region
cell (its deployment configuration and stream, seed 0, 17 ticks) through
the public engine API, then profiles one more ingest tick and one rank
cycle as phase 4 does (wall, device time, the kernels that take it and
each engine kernel's summed device time, ``chain_find`` and
``region_rank`` among them). ``--profile-hash-only`` does the same for the
hash cell (``score_gate`` and ``bucket_topk`` in its rank cycle), then
times ``score_gate``'s and ``assoc_score``'s bare launches on the
synthetic lanes and on the lanes its last rank cycle gave ``score_gate``.
``--root DIR`` takes the ``repro_torch`` package from ``DIR/src``, where
DIR lies inside this checkout (a parent commit unpacked with ``git
archive`` under ``build/``), so one call on one card profiles two trees.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32, outside the tensor cores
BF16_TC_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
# Exponentials: 16 a clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x the 1.98 GHz
# maximum boost clock (data sheet).
EXP_PER_S = 16 * 132 * 1.98e9
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


def score_floor():
    """``scripts/score_rate.py``'s measure(): the card's time for
    repro::score_body alone, ms per 2^24 scores (its "score" run less its
    "inputs" run, which makes the same inputs and skips the body), and the
    static SASS of its kernel."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "score_rate", ROOT / "scripts" / "score_rate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.measure()
    r = res["score"]
    log(f"  score floor (scripts/score_rate.py): {res['floor_ms_per_2_24']!r}"
        f" ms per 2^24 scores (scoring {r['ms_per_2_24']!r} less making the "
        f"inputs alone {res['inputs']['ms_per_2_24']!r}), "
        f"{r['sass_static']} static SASS (measured, not a bound)")
    return res


def floor_ms(floor, n_scored: int) -> float:
    return floor["floor_ms_per_2_24"] * n_scored / 2 ** 24


def score_gate_bytes(ok, passes, lazy: bool) -> int:
    """The bytes score_gate needs on these inputs: every slot's gate byte
    and score; the pair weight, count and source weight (and last_tick
    under the lazy policy) where the base gate is set; the dst weight and
    both counts' marginals where every gate passes; the three scalars."""
    C = ok.shape[0]
    return (C * 5 + int(ok.sum()) * (16 if lazy else 12)
            + int(passes.sum()) * 12 + 12)


def _times(fns):
    return {k: time_ms(fn) for k, fn in fns.items()}


def _unaligned(x):
    """``x`` copied into a view one element into a buffer of its own, a
    base that is not 16-byte aligned: the score kernels' 4-byte route."""
    buf = x.new_empty(x.numel() + 1)
    buf[1:].copy_(x)
    return buf[1:]


def score_gate_report(label, lanes, ok, lt, sc, half_life, gates, coefs,
                      floor):
    """score_gate on one set of lanes: the wrapper (its route counted) and
    its bare launch on these lanes and on copies one element off 16-byte
    alignment (the 4-byte route), each held against the plain version
    (bit-equal wherever the gates agree; gate flips only within 1 ulp of
    min_pair_weight, counted), then each bare launch timed against the bytes
    these inputs need, the 29 B (33 B lazy) a slot yardstick and the score
    floor times the slots scored. Returns the report."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as ktk
    kw = dict(coefs=coefs, half_life=half_life, **gates)
    routes = dict(ktk.SCORE_ROUTE_LAUNCHES)
    got = ktk.score_gate(*lanes, ok, lt, *sc, **kw)
    route = next(r for r, n in ktk.SCORE_ROUTE_LAUNCHES.items()
                 if n != routes[r])
    w_eff = lanes[0]
    if half_life is not None:
        w_eff = ktk.decay_exp2(lanes[0], lt, sc[2], half_life)
    exp = ref.score_gate_ref(w_eff, *lanes[1:], ok, sc[0], sc[1], coefs,
                             **gates)
    flips = torch.isneginf(got) != torch.isneginf(exp)
    near = (w_eff - gates["min_pair_weight"]).abs() <= 2.0 ** -23 * 0.25
    n_flips = int(flips.sum())
    if n_flips != int((flips & near).sum()):
        raise AssertionError(f"score_gate ({label}): gate masks differ away "
                             f"from the min_pair_weight boundary")
    if not torch.equal(got[~flips].view(torch.int32),
                       exp[~flips].view(torch.int32)):
        raise AssertionError(f"score_gate ({label}) differs from the plain "
                             f"version where the gates agree")
    both = ~flips & torch.isfinite(exp)
    err = float((got[both] - exp[both]).abs().max()) if bool(both.any()) \
        else 0.0
    scalars, gv = torch.stack(sc), tuple(gates.values())
    launches = {route: (lanes, ok, lt, torch.empty_like(got))}
    if route == "vec":
        launches["scalar"] = ([_unaligned(x) for x in lanes], _unaligned(ok),
                              None if lt is None else _unaligned(lt),
                              _unaligned(got))

    def launch(ls, o, l_t, out):
        ktk.launch_score_gate(ls, o, None if half_life is None
                              else l_t.data_ptr(), scalars, coefs, gv,
                              half_life, out)

    for name, args in launches.items():
        args[3].fill_(7.0)
        before = ktk.SCORE_ROUTE_LAUNCHES[name]
        launch(*args)
        if ktk.SCORE_ROUTE_LAUNCHES[name] != before + 1:
            raise AssertionError(f"score_gate ({label}) missed its {name} "
                                 f"route")
        if not torch.equal(args[3].view(torch.int32), got.view(torch.int32)):
            raise AssertionError(f"score_gate ({label}, {name} route) "
                                 f"differs from the wrapper's launch")
    ms = _times({name: (lambda args=args: launch(*args))
                 for name, args in launches.items()})
    C = got.shape[0]
    lazy = half_life is not None
    passes = got > -torch.inf
    n_ok, n_pass = int(ok.sum()), int(passes.sum())
    b_ms, b_by = bound(score_gate_bytes(ok, passes, lazy),
                       n_pass * SCORE_OPS_PER_SLOT)
    y_ms = bound(C * (33 if lazy else 29), 0)[0]
    f_ms = floor_ms(floor, n_pass) if floor else None
    log(f"  score_gate {label}, half_life={half_life}: C={C}, route "
        f"{route}, base gate {n_ok} ({100 * n_ok / C:.3f}%), {n_pass} pass "
        f"({100 * n_pass / C:.3f}%), gate flips within 1 ulp of "
        f"min_pair_weight {n_flips}; bound {b_ms!r} ms ({b_by}, the bytes "
        f"these inputs need), yardstick {y_ms!r} ms "
        f"({33 if lazy else 29} B a slot), score floor x {n_pass} scored "
        f"{f_ms!r} ms")
    for name, t in ms.items():
        log(f"  score_gate {label}, half_life={half_life}, {name} route: "
            f"{t!r} ms, {100 * b_ms / t:.2f}% of bound, {100 * y_ms / t:.2f}%"
            f" of the yardstick" + (f", {100 * f_ms / t:.2f}% of the score "
                                    f"floor" if f_ms else ""))
    return dict(ms=ms[route], route=route, slots=C, base_gate=n_ok,
                slots_pass=n_pass, gate_flips=n_flips, bound_ms=b_ms,
                bound_by=b_by, yardstick_bound_ms=y_ms, score_floor_ms=f_ms,
                ms_by_route=ms, max_abs_err=err)


def assoc_score_report(label, lanes, tot, coefs, floor):
    """assoc_score on one set of lanes, as score_gate_report: bit-equal to
    score_body on every slot, timed against the bytes these inputs need
    (c_ab and the score for every slot, the other five lanes where
    c_ab > 0), the 28 B a slot yardstick and the score floor."""
    import torch
    from repro_torch.kernels import assoc_score as kas
    routes = dict(kas.ROUTE_LAUNCHES)
    got = kas.assoc_score(*lanes, *tot, coefs=coefs)
    route = next(r for r, n in kas.ROUTE_LAUNCHES.items() if n != routes[r])
    exp = kas.score_body(*lanes, *tot, coefs)
    if not torch.equal(got.view(torch.int32), exp.view(torch.int32)):
        raise AssertionError(f"assoc_score ({label}) differs from score_body")
    fin = torch.isfinite(exp)
    err = float((got[fin] - exp[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    totals = torch.stack(tot)
    launches = {route: (lanes, torch.empty_like(got))}
    if route == "vec":
        launches["scalar"] = ([_unaligned(x) for x in lanes],
                              _unaligned(got))
    for name, (ls, out) in launches.items():
        out.fill_(7.0)
        before = kas.ROUTE_LAUNCHES[name]
        kas.launch_assoc_score(ls, totals, coefs, out)
        if kas.ROUTE_LAUNCHES[name] != before + 1:
            raise AssertionError(f"assoc_score ({label}) missed its {name} "
                                 f"route")
        if not torch.equal(out.view(torch.int32), got.view(torch.int32)):
            raise AssertionError(f"assoc_score ({label}, {name} route) "
                                 f"differs from the wrapper's launch")
    ms = _times({name: (lambda ls=ls, out=out: kas.launch_assoc_score(
        ls, totals, coefs, out)) for name, (ls, out) in launches.items()})
    C = got.shape[0]
    n_pos = int((lanes[1] > 0).sum())
    b_ms, b_by = bound(C * 8 + n_pos * 20 + 8, n_pos * SCORE_OPS_PER_SLOT)
    y_ms = bound(C * 28, 0)[0]
    f_ms = floor_ms(floor, n_pos) if floor else None
    log(f"  assoc_score {label}: C={C}, route {route}, c_ab > 0 at {n_pos} "
        f"({100 * n_pos / C:.3f}%); bound {b_ms!r} ms ({b_by}, the bytes "
        f"these inputs need), yardstick {y_ms!r} ms (28 B a slot), score "
        f"floor x {n_pos} scored {f_ms!r} ms")
    for name, t in ms.items():
        log(f"  assoc_score {label}, {name} route: {t!r} ms, "
            f"{100 * b_ms / t:.2f}% of bound, {100 * y_ms / t:.2f}% of the "
            f"yardstick" + (f", {100 * f_ms / t:.2f}% of the score floor"
                            if f_ms else ""))
    return dict(ms=ms[route], route=route, slots=C, slots_scored=n_pos,
                bound_ms=b_ms, bound_by=b_by, yardstick_bound_ms=y_ms,
                score_floor_ms=f_ms, ms_by_route=ms, max_abs_err=err)


def score_kernel_code() -> None:
    """The ``-Xptxas -v`` lines and static SASS counts of both kernels'
    instances."""
    for stem, kernel in (("score_gate", "score_gate_tile_kernel"),
                         ("assoc_score", "assoc_score_tile_kernel")):
        for line in ptxas_report(stem, kernel):
            log(f"    ptxas ({stem}): {line}")
        counts = sass_count(stem, kernel)
        log(f"    SASS instructions, static ({stem}): "
            + ("not measured" if counts is None else json.dumps(counts)))


def check_score_gate(C: int, dev, floor):
    """score_gate on the synthetic lanes (~71% of slots pass) under both
    decay policies (score_gate_report), its wrapper's and plain version's
    times, ptxas lines and static SASS counts."""
    from repro_torch.core.ranking import RankConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_select import score_gate
    rc = RankConfig()
    gates = dict(min_pair_weight=rc.min_pair_weight,
                 min_src_weight=rc.min_src_weight,
                 min_pair_count=rc.min_pair_count)
    lanes, ok, lt, sc = _score_inputs(C, dev)
    rep = {hl: score_gate_report("synthetic lanes", lanes, ok, lt, sc, hl,
                                 gates, rc.coefs, floor)
           for hl in (None, 36.0)}
    score_kernel_code()
    kw = dict(coefs=rc.coefs, half_life=None, **gates)
    wrapper_ms = time_ms(lambda: score_gate(*lanes, ok, lt, *sc, **kw))
    plain_ms = time_ms(lambda: ref.score_gate_ref(
        *lanes, ok, sc[0], sc[1], rc.coefs, **gates))
    r, lz = rep[None], rep[36.0]
    return dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None, kernel_route=r["route"],
                slots_pass=r["slots_pass"],
                yardstick_bound_ms=r["yardstick_bound_ms"],
                score_floor_ms=r["score_floor_ms"],
                ms_by_route=r["ms_by_route"], lazy_ms=lz["ms"],
                lazy_max_abs_err=lz["max_abs_err"],
                lazy_bound_ms=lz["bound_ms"],
                lazy_slots_pass=lz["slots_pass"],
                lazy_gate_flips=lz["gate_flips"])


def check_assoc_score(C: int, dev, floor):
    """The stand-alone assoc_score kernel on the synthetic lanes
    (assoc_score_report; no engine caller: its launches on the main paths
    are 0), its wrapper's and plain version's times."""
    from repro_torch.core.ranking import RankConfig
    from repro_torch.kernels.assoc_score import assoc_score, score_body
    coefs = RankConfig().coefs
    lanes, _, _, sc = _score_inputs(C, dev)
    r = assoc_score_report("synthetic lanes", lanes, sc[:2], coefs, floor)
    wrapper_ms = time_ms(lambda: assoc_score(*lanes, sc[0], sc[1],
                                             coefs=coefs))
    plain_ms = time_ms(lambda: score_body(*lanes, sc[0], sc[1], coefs))
    return dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                library_ms=None, kernel_route=r["route"],
                slots_scored=r["slots_scored"],
                yardstick_bound_ms=r["yardstick_bound_ms"],
                score_floor_ms=r["score_floor_ms"],
                ms_by_route=r["ms_by_route"])


def check_score_path_lanes(call, tick, floor):
    """score_gate and assoc_score on the lanes the hash path's rank cycle of
    ``tick`` passed score_gate (an untimed replay): score_gate_report on
    them, and assoc_score_report on the same six lanes."""
    import torch
    a, kw = call
    w_ab, c_ab, w_a, w_b, c_a, c_b, ok, total_w, total_c = a
    if kw.get("decay_cfg") is not None:
        raise AssertionError("the hash cell runs the sweep policy")
    total_w, total_c = (x.to(torch.float32).reshape(())
                        for x in (total_w, total_c))
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b)
    gates = dict(min_pair_weight=kw["min_pair_weight"],
                 min_src_weight=kw["min_src_weight"],
                 min_pair_count=kw["min_pair_count"])
    label = f"hash path lanes, tick {tick}"
    sc = [total_w, total_c, total_w.new_zeros(())]
    sg = score_gate_report(label, lanes, ok, None, sc, None, gates,
                           kw["coefs"], floor)
    asc = assoc_score_report(label, lanes, [total_w, total_c], kw["coefs"],
                             floor)
    return {"score_gate": sg, "assoc_score": asc}


def region_rank_routes(label, lanes, ok, lt, sc, K, half_life, gates,
                       coefs):
    """region_rank on one grid through both kernel routes: the wrapper
    (which must take the row route) and the warp route forced through its
    bare launch, each held against the plain version: npass, values and
    columns equal, apart from rows where the lazy gate sits within 1 ulp of
    min_pair_weight (counted and printed). Returns (max_abs_err, the
    outputs' buffers, the plain npass)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as ktk
    kw = dict(k=K, coefs=coefs, **gates)
    if ktk.kernel_route(K) != "row":
        raise AssertionError(f"region_rank K={K} does not take the row route")
    before = dict(ktk.REGION_ROUTE_LAUNCHES)
    vals, args, npass = ktk.region_rank(*lanes, ok, lt, *sc,
                                        half_life=half_life, **kw)
    if ktk.REGION_ROUTE_LAUNCHES["row"] != before["row"] + 1:
        raise AssertionError("region_rank's wrapper did not take the row "
                             "route")
    bufs = (torch.empty_like(vals), torch.empty_like(args),
            torch.empty_like(npass))
    lt_ptr = None if half_life is None else lt.data_ptr()
    ktk.launch_region_rank(lanes, ok, lt_ptr, torch.stack(sc), coefs,
                           tuple(gates.values()), half_life, *bufs,
                           kroute="warp")
    w_eff = lanes[0]
    if half_life is not None:
        w_eff = ktk.decay_exp2(lanes[0], lt, sc[2], half_life)
    ev, ea, en = ref.region_rank_ref(w_eff, *lanes[1:], ok, sc[0], sc[1],
                                     **kw)
    near = ((w_eff - gates["min_pair_weight"]).abs()
            <= 2.0 ** -23 * 0.25).any(1)
    err = 0.0
    for kroute, (v, a, n) in (("row", (vals, args, npass)), ("warp", bufs)):
        same = (n == en) & (v == ev).all(1) & (a == ea).all(1)
        n_flip_rows = int((~same).sum())
        if n_flip_rows != int((~same & near).sum()):
            raise AssertionError(f"region_rank ({kroute} route, {label}) "
                                 f"differs from the plain version away from "
                                 f"the min_pair_weight boundary")
        fin = (v > -torch.inf) & (ev > -torch.inf) & same[:, None]
        e = float((v[fin] - ev[fin]).abs().max()) if bool(fin.any()) else 0.0
        err = max(err, e)
        log(f"  region_rank {kroute} route, {label}, half_life={half_life}: "
            f"max_abs_err={e!r}, rows differing (gate within 1 ulp of "
            f"min_pair_weight)={n_flip_rows} of {v.shape[0]}")
    return err, bufs, en


def time_region_rank_routes(lanes, ok, lt, sc, half_life, gates, coefs,
                            bufs):
    """Each route's bare launch on one grid, timed: {route: ms}."""
    import torch
    from repro_torch.kernels import topk_select as ktk
    scalars = torch.stack(sc)
    lt_ptr = None if half_life is None else lt.data_ptr()
    return {kroute: time_ms(lambda: ktk.launch_region_rank(
        lanes, ok, lt_ptr, scalars, coefs, tuple(gates.values()), half_life,
        *bufs, kroute=kroute)) for kroute in ("row", "warp")}


def region_rank_bound(ok, w_a, npass, K: int, min_src_weight: float,
                      lazy: bool):
    """region_rank's bound on one grid, from the bytes this data needs:
    the base gate byte of each slot of a row whose source passes
    min_src_weight; the pair's weight and count (and its i32 last_tick
    under the lazy policy) where the base gate and the source pass; the dst
    marginals' weight and count where every gate passes; per row its
    source weight, its source count where a slot passes, K values, K
    columns and npass written. Operations: one score (SCORE_OPS_PER_SLOT)
    a passing slot."""
    R, W = ok.shape
    src = w_a >= min_src_weight
    n_open = int((ok & src[:, None]).sum())
    n_pass = int(npass.sum())
    n_bytes = (int(src.sum()) * W + n_open * (12 if lazy else 8)
               + n_pass * 8 + R * 4 + int((npass > 0).sum()) * 4
               + R * (K * 8 + 4))
    return bound(n_bytes, n_pass * SCORE_OPS_PER_SLOT)


def sass_count(stem: str, kernel: str):
    """Static SASS instructions of the entry functions of csrc/<stem>.cu
    whose names contain ``kernel`` (``cuobjdump -sass`` of the built
    library): {function: count}, or None without cuobjdump."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    lib = build.library_path(build.CSRC / f"{stem}.cu")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                out[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            out[name] += 1
    return out


def check_region_rank(R: int, W: int, K: int, dev, floor):
    """region_rank's two routes with and without in-kernel decay against
    the plain version on a synthetic grid (72% of slots pass), both timed
    by their bare launches against the bytes this grid needs
    (:func:`region_rank_bound`), against the yardstick of 17 B a slot
    (21 B under the lazy policy) that every slot would need were it all
    read, and against the score floor times the slots scored; fails unless
    the row route is the faster. Prints each kernel's ptxas lines and
    static SASS count."""
    import numpy as np
    import torch
    from repro_torch.core.ranking import RankConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_select import region_rank
    rc = RankConfig()
    gates = dict(min_pair_weight=rc.min_pair_weight,
                 min_src_weight=rc.min_src_weight,
                 min_pair_count=rc.min_pair_count)
    rng = np.random.default_rng(SEED + 3)
    mk = lambda *s: torch.from_numpy(rng.random(s, dtype=np.float32)).to(dev)
    w_ab, c_ab = mk(R, W) * 5, torch.floor(mk(R, W) * 20)
    w_a, w_b = mk(R) * 50, mk(R, W) * 50
    c_a = torch.floor(mk(R) * 100) + 20
    c_b = torch.maximum(c_ab, torch.floor(mk(R, W) * 100))
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b)
    ok = torch.from_numpy(rng.random((R, W)) < 0.8).to(dev)
    lt = torch.from_numpy(rng.integers(0, 17, (R, W)).astype(np.int32)).to(dev)
    sc = [torch.tensor(x, dtype=torch.float32, device=dev)
          for x in (float(R * W) * 2.0, float(R * W) * 4.0, 17.0)]
    kw = dict(k=K, coefs=rc.coefs, **gates)
    err, ms, bnd, yard = 0.0, {}, {}, {}
    for half_life in (None, 36.0):
        e, bufs, en = region_rank_routes("synthetic grid", lanes, ok, lt, sc,
                                         K, half_life, gates, rc.coefs)
        err = max(err, e)
        ms[half_life] = time_region_rank_routes(lanes, ok, lt, sc, half_life,
                                                gates, rc.coefs, bufs)
        lazy = half_life is not None
        bnd[half_life] = (int(en.sum()), *region_rank_bound(
            ok, w_a, en, K, gates["min_src_weight"], lazy))
        yard[half_life] = bound(R * W * (21 if lazy else 17)
                                + R * (8 + K * 8 + 4), 0)[0]
    for half_life in (None, 36.0):
        n_pass, bm, b_by = bnd[half_life]
        ym = yard[half_life]
        fm = floor_ms(floor, n_pass)
        log(f"  region_rank synthetic grid ({R}x{W}, K={K}), half_life="
            f"{half_life}: {n_pass} slots pass "
            f"({100 * n_pass / (R * W):.2f}%); bound {bm!r} ms ({b_by}), "
            f"yardstick at every slot's {21 if half_life else 17} B "
            f"{ym!r} ms, score floor x {n_pass} scored {fm!r} ms")
        for kroute in ("row", "warp"):
            t = ms[half_life][kroute]
            log(f"  region_rank {kroute} route, synthetic grid, "
                f"half_life={half_life}: {t!r} ms, {100 * bm / t:.2f}% of "
                f"bound, {100 * ym / t:.2f}% of the yardstick, "
                f"{100 * fm / t:.2f}% of the score floor")
    _, b_ms, b_by = bnd[None]
    _, lazy_b_ms, _ = bnd[36.0]
    if not ms[None]["row"] < ms[None]["warp"]:
        raise AssertionError(f"region_rank: the row route ({ms[None]['row']} "
                             f"ms) is not faster than the warp route "
                             f"({ms[None]['warp']} ms)")
    log(f"  region_rank synthetic grid: row route "
        f"{ms[None]['warp'] / ms[None]['row']:.2f}x faster than the warp "
        f"route")
    for stem, entry in (("row", "region_rank_row_kernel"),
                        ("warp", "region_rank_kernel")):
        for line in ptxas_report("region_rank", entry):
            log(f"    ptxas ({stem} route): {line}")
    # the engine's instances (W 128, K 8)
    for what, stem, kernel in (
            ("row route", "region_rank", "region_rank_row_kernelILi4ELi8E"),
            ("warp route", "region_rank", "region_rank_kernelILi4E")):
        counts = sass_count(stem, kernel)
        n = "not measured" if counts is None else sum(counts.values())
        log(f"    SASS instructions, static ({what}): {n}")
    wrapper_ms = time_ms(lambda: region_rank(*lanes, ok, lt, *sc, **kw))
    plain_ms = time_ms(lambda: ref.region_rank_ref(*lanes, ok, sc[0], sc[1],
                                                   **kw))
    return dict(max_abs_err=err, ms=ms[None]["row"], wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, kernel_route="row",
                yardstick_bound_ms=yard[None], slots_pass=bnd[None][0],
                warp_route_ms=ms[None]["warp"], lazy_ms=ms[36.0]["row"],
                lazy_warp_route_ms=ms[36.0]["warp"], lazy_bound_ms=lazy_b_ms,
                lazy_yardstick_bound_ms=yard[36.0],
                lazy_slots_pass=bnd[36.0][0],
                score_floor_ms=floor_ms(floor, bnd[None][0]))


def check_region_rank_path_grid(call, tick, floor):
    """region_rank's two routes on the grid the region path's rank cycle of
    ``tick`` passed it (an untimed replay): the live and passing slots, each
    route against the plain version, both timed against the bytes that data
    needs (:func:`region_rank_bound`) and against a yardstick that reads
    the base gate byte of every slot, 16 B for each live slot, and each
    row's two marginals, K values, K columns and npass."""
    a, kw = call
    w_ab, c_ab, w_a, w_b, c_a, c_b, ok, total_w, total_c = a
    if kw.get("decay_cfg") is not None:
        raise AssertionError("the region cell runs the sweep policy")
    R, W = w_ab.shape
    K = kw["k"]
    gates = dict(min_pair_weight=kw["min_pair_weight"],
                 min_src_weight=kw["min_src_weight"],
                 min_pair_count=kw["min_pair_count"])
    lanes = (w_ab, c_ab, w_a, w_b, c_a, c_b)
    sc = [total_w, total_c, total_w.new_zeros(())]
    label = f"region path grid, tick {tick}"
    err, bufs, en = region_rank_routes(label, lanes, ok, None, sc, K, None,
                                       gates, kw["coefs"])
    ms = time_region_rank_routes(lanes, ok, None, sc, None, gates,
                                 kw["coefs"], bufs)
    n_ok, n_pass = int(ok.sum()), int(en.sum())
    rows_free = int((~ok.any(1)).sum())
    src_rows = int((w_a >= gates["min_src_weight"]).sum())
    b_ms, b_by = region_rank_bound(ok, w_a, en, K, gates["min_src_weight"],
                                   False)
    y_ms = bound(R * W + n_ok * 16 + R * (8 + K * 8 + 4), 0)[0]
    f_ms = floor_ms(floor, n_pass)
    log(f"  region_rank {label}: {R}x{W}, K={K}, {n_ok} slots live "
        f"({100 * n_ok / (R * W):.3f}%), {n_pass} pass "
        f"({100 * n_pass / (R * W):.3f}%), {rows_free} rows with no live "
        f"slot, {src_rows} rows whose source passes; bound {b_ms!r} ms "
        f"({b_by}), yardstick (every gate byte, 16 B a live slot) "
        f"{y_ms!r} ms, score floor x {n_pass} scored {f_ms!r} ms")
    for kroute in ("row", "warp"):
        log(f"  region_rank {kroute} route, {label}: {ms[kroute]!r} ms, "
            f"{100 * b_ms / ms[kroute]:.2f}% of that data's bound, "
            f"{100 * y_ms / ms[kroute]:.2f}% of the yardstick")
    return dict(rows=R, width=W, k=K, slots_live=n_ok, slots_pass=n_pass,
                rows_without_live_slot=rows_free, rows_source_pass=src_rows,
                row_ms=ms["row"], warp_ms=ms["warp"], bound_ms=b_ms,
                bound_by=b_by, yardstick_bound_ms=y_ms, score_floor_ms=f_ms,
                max_abs_err=err)


def chain_find_sweep(kh, kl, batch, kroute, out):
    """chain_find's bare launch on one batch at each rows-a-warp the
    kernel takes, on ``kroute``, each result held exactly against the
    wrapper's: {rows a warp: ms}."""
    import torch
    from repro_torch.kernels.region_probe import chain_find, launch_chain_find
    exp = chain_find(kh, kl, *batch)
    ms = {}
    for rpw in (1, 2, 4, 8, 16, 32):
        launch_chain_find(kh, kl, *batch, out, kroute=kroute, rpw=rpw)
        if not torch.equal(out, exp):
            raise AssertionError(f"chain_find at {rpw} rows a warp differs")
        ms[rpw] = time_ms(lambda: launch_chain_find(
            kh, kl, *batch, out, kroute=kroute, rpw=rpw))
    return ms


def check_chain_find(table, batch, dev):
    """chain_find on the region store and largest pair batch of the
    phase-4 region run's ticks, held exactly against the plain version;
    the batch's active share and the 32-row groups and the groups of a
    warp's rows without an active row, its time and its share of the
    bound, the other route's time forced through the bare launch, and the
    time at each rows-a-warp."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import region_probe as kprobe
    from repro_torch.kernels.region_probe import chain_find, launch_chain_find
    R, W = table.n_regions, table.width
    kh, kl = table.key_hi.view(R, W), table.key_lo.view(R, W)
    regs, dh, dl, active = batch
    B, MC = regs.shape
    by_route = dict(kprobe.ROUTE_LAUNCHES)
    got = chain_find(kh, kl, regs, dh, dl, active)
    kroute = kprobe.kernel_route(kh, kl)
    if kprobe.ROUTE_LAUNCHES[kroute] != by_route[kroute] + 1:
        raise AssertionError(f"chain_find did not take the {kroute} route")
    exp = ref.chain_find_ref(kh, kl, regs, dh, dl, active)
    if not torch.equal(got, exp):
        raise AssertionError("chain_find differs from the plain version")
    # what this data needs: an active row reads its chain's region ids up
    # to the hit (all MC on a miss), its dst key, and one region row of
    # keys per region visited; every row reads its active flag and writes
    # its result.
    hit = got >= 0
    hit_depth = torch.argmax((regs == torch.div(
        got, W, rounding_mode="floor")[:, None]).to(torch.uint8), 1)
    ids_read = torch.where(hit, hit_depth + 1, MC)
    visited = torch.where(hit, (regs >= 0).cumsum(1).gather(
        1, hit_depth[:, None])[:, 0], (regs >= 0).sum(1))
    n_active = int(active.sum())
    n_ids = int(torch.where(active, ids_read, 0).sum())
    n_visits = int(torch.where(active, visited, 0).sum())
    target = kprobe.target_warps(dev, W, kroute == "vec")
    rpw = kprobe.rows_per_warp(B, target)
    idle = {}
    for g in sorted({32, rpw}):
        groups = -(-B // g)
        pad = torch.zeros(groups * g, dtype=torch.bool, device=dev)
        pad[:B] = active
        idle[g] = (int((~pad.view(groups, g).any(1)).sum()), groups)
    log(f"  chain_find: {B} rows ({n_active} active, "
        f"{100 * n_active / B:.3f}%; {int(hit.sum())} hits), "
        + ", ".join(f"{n} of {groups} {g}-row groups"
                    for g, (n, groups) in idle.items())
        + f" with no active row, {n_ids} region ids "
        f"and {n_visits} region rows read, MC={MC}, W={W}, {kroute} route, "
        f"{rpw} rows a warp (target {target} warps: {kprobe.WAVES} waves "
        f"of {target // kprobe.WAVES} resident)")
    out = torch.empty_like(got)
    ms = time_ms(lambda: launch_chain_find(kh, kl, regs, dh, dl, active, out))
    other = "scalar" if kroute == "vec" else None
    other_ms = None
    if other:
        launch_chain_find(kh, kl, regs, dh, dl, active, out, kroute=other)
        if not torch.equal(out, exp):
            raise AssertionError(f"chain_find's {other} route differs from "
                                 f"the plain version")
        other_ms = time_ms(lambda: launch_chain_find(
            kh, kl, regs, dh, dl, active, out, kroute=other))
    wrapper_ms = time_ms(lambda: chain_find(kh, kl, regs, dh, dl, active))
    plain_ms = time_ms(lambda: ref.chain_find_ref(kh, kl, regs, dh, dl,
                                                  active))
    b_ms, b_by = bound(n_ids * 4 + n_active * 8 + B * (1 + 4)
                       + n_visits * W * 8, n_visits * W * 2)
    log(f"  chain_find: {ms!r} ms, {100 * b_ms / ms:.2f}% of bound "
        f"({b_ms!r} ms, {b_by}), {B / ms / 1e3:.1f} rows/us")
    if other:
        log(f"  chain_find {other} route forced, same batch: {other_ms!r} "
            f"ms, {100 * b_ms / other_ms:.2f}% of bound; {kroute} route "
            f"{other_ms / ms:.3f}x faster")
    sweep = chain_find_sweep(kh, kl, batch, kroute, out)
    log(f"  chain_find by rows a warp, {B}-row batch: {sweep}")
    for line in ptxas_report("chain_find", "chain_find_kernel"):
        log(f"    ptxas: {line}")
    return dict(max_abs_err=0.0, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, kernel_route=kroute, rows_per_warp=rpw,
                other_route_ms=other_ms, ms_by_rows_per_warp=sweep)


def check_chain_find_batch(table, batch):
    """chain_find on another of the region run's batch sizes: held exactly
    against the plain version, its active share, rows a warp and time, and
    the time at each rows-a-warp."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import region_probe as kprobe
    R, W = table.n_regions, table.width
    kh, kl = table.key_hi.view(R, W), table.key_lo.view(R, W)
    regs, dh, dl, active = batch
    got = kprobe.chain_find(kh, kl, regs, dh, dl, active)
    if not torch.equal(got, ref.chain_find_ref(kh, kl, regs, dh, dl,
                                               active)):
        raise AssertionError("chain_find differs from the plain version")
    B, n_active = regs.shape[0], int(active.sum())
    kroute = kprobe.kernel_route(kh, kl)
    rpw = kprobe.rows_per_warp(B, kprobe.target_warps(
        regs.device, W, kroute == "vec"))
    out = torch.empty_like(got)
    ms = time_ms(lambda: kprobe.launch_chain_find(kh, kl, regs, dh, dl,
                                                  active, out))
    log(f"  chain_find, a {B}-row batch ({n_active} active, "
        f"{100 * n_active / B:.3f}%), {rpw} rows a warp: {ms!r} ms")
    sweep = chain_find_sweep(kh, kl, batch, kroute, out)
    log(f"  chain_find by rows a warp, {B}-row batch: {sweep}")
    return dict(rows=B, active=n_active, rows_per_warp=rpw, ms=ms,
                ms_by_rows_per_warp=sweep)


def topk_bound(R: int, L: int, K: int):
    """bucket_topk's bound: the grid read once, K values and K columns
    written per row; its K rounds of L compares as operations."""
    return bound(R * L * 4 + R * K * 8, R * L * K)


def bucket_topk_routes(label: str, grid, K: int):
    """bucket_topk on ``grid`` through both kernel routes: the wrapper
    (which must take the row route) and the warp route forced through its
    bare launch. Each is held against the plain version (values, and every
    column with its sentinels) and timed by its bare launch. Returns
    {route: ms}."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import topk_select as ktk
    R, L = grid.shape
    if ktk.kernel_route(K) != "row":
        raise AssertionError(f"bucket_topk K={K} does not take the row route")
    ev, ea = ref.bucket_topk_ref(grid, K)
    before = dict(ktk.ROUTE_LAUNCHES)
    vals, args = ktk.bucket_topk(grid, K)
    if ktk.ROUTE_LAUNCHES["row"] != before["row"] + 1:
        raise AssertionError("bucket_topk's wrapper did not take the row "
                             "route")
    bv, ba = torch.empty_like(vals), torch.empty_like(args)
    ktk.launch_bucket_topk(grid, bv, ba, "warp")
    for kroute, (v, a) in (("row", (vals, args)), ("warp", (bv, ba))):
        if not (torch.equal(v, ev) and torch.equal(a, ea)):
            raise AssertionError(f"bucket_topk ({kroute} route, {label}) "
                                 f"differs from the plain version")
    del vals, args
    b_ms, b_by = topk_bound(R, L, K)
    ms = {}
    for kroute in ("row", "warp"):
        ms[kroute] = time_ms(
            lambda: ktk.launch_bucket_topk(grid, bv, ba, kroute))
        log(f"  bucket_topk {kroute} route, {label} ({R}x{L}, K={K}): "
            f"equal to the plain version (values, columns, sentinels), "
            f"{ms[kroute]!r} ms, {100 * b_ms / ms[kroute]:.2f}% of bound "
            f"({b_ms!r} ms, {b_by}), {R / ms[kroute] / 1e3:.1f} rows/us")
    log(f"  bucket_topk {label}: the wrapper took the row route; row "
        f"route {ms['warp'] / ms['row']:.2f}x faster than the warp route")
    return ms


def check_bucket_topk(R: int, L: int, K: int, dev):
    """bucket_topk's two routes against the plain version on a synthetic
    grid (half -inf, many ties), with torch.topk timed beside them as the
    library yardstick; fails unless the row route is the faster."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_select import bucket_topk
    rng = np.random.default_rng(SEED + 2)
    g = np.floor(rng.random((R, L), dtype=np.float32) * 64)     # many ties
    g[rng.random((R, L)) < 0.5] = -np.inf
    grid = torch.from_numpy(g).to(dev)
    del g
    ms = bucket_topk_routes("synthetic grid", grid, K)
    for stem, entry in (("row", "bucket_topk_row_kernel"),
                        ("warp", "bucket_topk_kernel")):
        for line in ptxas_report("bucket_topk", entry):
            log(f"    ptxas ({stem} route): {line}")
    if not ms["row"] < ms["warp"]:
        raise AssertionError(f"bucket_topk: the row route ({ms['row']} ms) "
                             f"is not faster than the warp route "
                             f"({ms['warp']} ms)")
    wrapper_ms = time_ms(lambda: bucket_topk(grid, K))
    plain_ms = time_ms(lambda: ref.bucket_topk_ref(grid, K))
    library_ms = time_ms(lambda: torch.topk(grid, K, dim=1))
    b_ms, b_by = topk_bound(R, L, K)
    return dict(max_abs_err=0.0, ms=ms["row"], wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                kernel_route="row", warp_route_ms=ms["warp"])


def check_bucket_topk_path_grid(label: str, grid, K: int):
    """bucket_topk's two routes on a grid a main path passed it (from an
    untimed replay): rows holding a finite value, each route against the
    plain version, both timed; ``torch.topk`` beside them."""
    import torch
    R, L = grid.shape
    n_live = int(torch.isfinite(grid).any(1).sum())
    log(f"  bucket_topk {label}: {R}x{L}, K={K}, {n_live} rows hold a "
        f"finite value ({100 * n_live / max(R, 1):.3f}%)")
    ms = bucket_topk_routes(label, grid, K)
    library_ms = time_ms(lambda: torch.topk(grid, K, dim=1))
    b_ms, _ = topk_bound(R, L, K)
    return dict(rows=R, width=L, rows_finite=n_live, row_ms=ms["row"],
                warp_ms=ms["warp"], bound_ms=b_ms, library_ms=library_ms)


ED_OPS_PER_CELL = 7   # f32 adds and mins per DP cell, the bound's yardstick
ED_FC_F32 = 1.3       # a first-character cost only the f32 route takes


def check_edit_distance(batch, fc: float):
    """edit_distance on the largest pair batch of the spelling job, on both
    kernel routes with the same pairs: the job's cost ``fc`` (half-unit
    route) and ``ED_FC_F32`` (f32 route), each held bit for bit against
    the plain version and timed by its bare launch. The bound counts the
    cells these pairs fill (a_len x b_len each) at ED_OPS_PER_CELL f32
    operations, on both routes. Fails unless the half-unit route is
    faster."""
    import torch
    from repro_torch.kernels import edit_distance as ked
    from repro_torch.kernels import ref
    ac, al, bc, bl = batch
    B, L = ac.shape
    cells = int((al.long() * bl.long()).sum())
    b_ms, b_by = bound(B * (2 * L + 8 + 4), cells * ED_OPS_PER_CELL)
    log(f"  edit_distance: {B} pairs, L={L}, {cells} DP cells "
        f"({cells / max(B, 1):.1f} a pair), bound {b_ms} ms ({b_by})")
    if ked.kernel_route(fc) != "half":
        raise AssertionError(f"the job's first_char_cost {fc} does not take "
                             f"the half-unit route")
    out = torch.empty((B,), dtype=torch.float32, device=ac.device)
    by_route = {}
    for cost in (fc, ED_FC_F32):
        kroute = ked.kernel_route(cost)
        before = dict(ked.ROUTE_LAUNCHES)
        got = ked.edit_distance(ac, al, bc, bl, first_char_cost=cost)
        n_route = ked.ROUTE_LAUNCHES[kroute] - before[kroute]
        if n_route != 1:
            raise AssertionError(f"edit_distance fc {cost}: {n_route} "
                                 f"launches on the {kroute} route")
        exp = ref.edit_distance_ref(ac, al, bc, bl, first_char_cost=cost)
        if not torch.equal(got.view(torch.int32), exp.view(torch.int32)):
            raise AssertionError(f"edit_distance ({kroute} route, fc "
                                 f"{cost}) differs from the plain version")
        ms = time_ms(lambda: ked.launch(ac, al, bc, bl, out, cost))
        by_route[kroute] = dict(fc=cost, ms=ms,
                                max_abs_err=float((got - exp).abs().max()))
        del got, exp
        log(f"  edit_distance {kroute} route (first_char_cost={cost}): "
            f"{n_route} launch on it, bit-equal to the plain version, "
            f"{ms} ms, "
            f"{100 * b_ms / ms:.2f}% of bound, {cells / ms / 1e3:.1f} "
            f"cells/us")
        for line in ptxas_report("edit_distance", f"ed_{kroute}_kernel"):
            log(f"    ptxas: {line}")
    half, f32 = by_route["half"], by_route["f32"]
    if not half["ms"] < f32["ms"]:
        raise AssertionError(f"edit_distance: the half-unit route "
                             f"({half['ms']} ms) is not faster than the f32 "
                             f"route ({f32['ms']} ms)")
    log(f"  edit_distance: half-unit route {f32['ms'] / half['ms']:.2f}x "
        f"faster than the f32 route on the same pairs")
    wrapper_ms = time_ms(lambda: ked.edit_distance(ac, al, bc, bl,
                                                   first_char_cost=fc))
    plain_ms = time_ms(lambda: ref.edit_distance_ref(ac, al, bc, bl, fc),
                       reps=3, warmup=1)
    return dict(max_abs_err=half["max_abs_err"], ms=half["ms"],
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, kernel_route="half",
                f32_route_ms=f32["ms"],
                f32_route_max_abs_err=f32["max_abs_err"])


# ---------------------------------------------------------------------------
# Phases 3-5: the engine.
# ---------------------------------------------------------------------------

def engine_stream_config():
    from repro_torch.data.stream import StreamConfig
    return StreamConfig(vocab_size=256, n_users=150, queries_per_tick=128,
                        tweets_per_tick=16, tweet_words=4, tweet_grams=6)


def small_parity(dev, layout="hash", lazy=False):
    """The engine on the card against the engine on the CPU, on the
    ``tests/test_engine.py`` stream and configuration (9 ticks)."""
    import numpy as np
    from repro_torch.core.decay import DecayConfig
    from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
    from repro_torch.data.stream import SyntheticStream
    kw = dict(decay=DecayConfig(policy="lazy"), prune_every=4) if lazy else {}
    cfg = EngineConfig(query_capacity=1 << 12, cooc_capacity=1 << 14,
                       session_capacity=1 << 11, session_window=4,
                       decay_every=4, rank_every=8, cooc_layout=layout, **kw)
    engines = []
    for device in (dev, "cpu"):
        stream = SyntheticStream(engine_stream_config(), seed=11)
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
    log(f"  {layout} layout, {'lazy' if lazy else 'sweep'} policy, card vs "
        f"CPU: {n_exact}/{len(a)} leaves bit-identical, keys and "
        f"slots exact, {len(sa)} sources, top-3 identity agreement "
        f"{agree}/{len(sa)}")
    return engines


PLANTED = [("justin bieber", 900.0), ("justin beiber", 5.0),
           ("justin biber", 3.0), ("hadoop", 800.0), ("hadop", 4.0),
           ("lady gaga", 700.0), ("lady gagga", 6.0), ("world cup", 600.0),
           ("wrold cup", 2.0)]
TRUE_FORM = {"justin beiber": "justin bieber", "justin biber": "justin bieber",
             "hadop": "hadoop", "lady gagga": "lady gaga",
             "wrold cup": "world cup"}


def small_spelling(dev, engine) -> None:
    """The spelling job on the card against the CPU over a small engine's
    live qstore plus planted misspellings, and a count-min sketch on the
    card against the CPU (integer weights, so sums are exact)."""
    import numpy as np
    import torch
    from repro_torch.core import sketch as tsk
    from repro_torch.core.hashing import fingerprint, from_np_u32, join_fp
    from repro_torch.core.spelling import spelling_cycle
    from repro_torch.core.stores import export_live
    from repro_torch.data.stream import SyntheticStream
    exp = export_live(engine.state.qstore)
    tok = SyntheticStream(engine_stream_config(), seed=11).tok
    fps = join_fp(exp["key_hi"], exp["key_lo"])
    texts = [tok.text(int(f)) for f in fps] + [t for t, _ in PLANTED]
    fps = np.concatenate([fps, np.array([fingerprint(t) for t, _ in PLANTED],
                                        np.uint64)])
    weights = np.concatenate([exp["weight"],
                              np.float32([w for _, w in PLANTED])])
    got = spelling_cycle(fps, texts, weights, device=dev)
    cpu = spelling_cycle(fps, texts, weights, device="cpu")
    if list(got.items()) != list(cpu.items()) or not got:
        raise AssertionError("spelling job differs between card and CPU")
    fixed = sum(got.get(fingerprint(v), (None,))[0] == fingerprint(t)
                for v, t in TRUE_FORM.items())
    rng = np.random.default_rng(SEED + 5)
    hi = rng.integers(0, 2**32, 1 << 16, dtype=np.uint32)
    lo = rng.integers(0, 2**32, 1 << 16, dtype=np.uint32)
    w = np.floor(rng.random(1 << 16) * 8).astype(np.float32)
    valid = rng.random(1 << 16) < 0.9
    res = []
    for d in (dev, "cpu"):
        kh, kl = from_np_u32(hi, d), from_np_u32(lo, d)
        sk = tsk.sketch_update(tsk.make_sketch(4, 1 << 12, device=d), kh, kl,
                               torch.from_numpy(w).to(d),
                               torch.from_numpy(valid).to(d))
        sk = tsk.sketch_decay(sk, 0.5)
        res.append((sk.table.cpu(), tsk.sketch_query(sk, kh, kl).cpu()))
    if not all(torch.equal(x, y) for x, y in zip(*res)):
        raise AssertionError("count-min sketch differs between card and CPU")
    log(f"  spelling job, card vs CPU: {len(fps)} sources ({len(PLANTED)} "
        f"planted), {len(got)} corrections, same items in the same order; "
        f"planted misspellings corrected {fixed}/{len(TRUE_FORM)}; "
        f"count-min sketch 4 x 4096 over {1 << 16} keys: table and "
        f"queries equal")


def deployment_config(layout="hash"):
    from repro_torch.core.engine import EngineConfig
    from repro_torch.data.stream import StreamConfig
    return (EngineConfig(query_capacity=1 << 22, cooc_capacity=1 << 24,
                         session_capacity=1 << 20, decay_every=4,
                         rank_every=8, cooc_layout=layout),
            StreamConfig(vocab_size=65536, n_users=200000,
                         queries_per_tick=16384, tweets_per_tick=2048))


def main_path(dev, ticks, layout):
    """Drive SearchAssistanceEngine.step over the pre-generated ticks with
    the launch counts set to 0 just before and read just after."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core import engine as te
    cfg, scfg = deployment_config(layout)
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
                log(f"  {layout} tick {res['tick']}: rank cycle -> "
                    f"{res['n_suggest']} "
                    f"queries with suggestions ({res['n_rows']} rows, "
                    f"{res['n_overflow']} overflow)")
    finally:
        te.decay_cycle = decay_cycle
    launches = dict(tk.LAUNCHES)
    return eng, step_ms, cycle_ms, results, launches


# The engine's kernels, each named in its CUDA kernels' function names.
ENGINE_KERNELS = ("decay_prune_multi", "score_gate", "bucket_topk",
                  "chain_find", "region_rank")


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
    ours = {name: [0.0, 0] for name in ENGINE_KERNELS}
    for key, ms, n in rows:
        for name in ENGINE_KERNELS:
            if name in key:
                ours[name][0] += ms
                ours[name][1] += n
    if any(n for _, n in ours.values()):
        log(f"  profiled {label}, engine kernels: " + ", ".join(
            f"{name} {ms!r} ms x{n}" for name, (ms, n) in ours.items()
            if n))


def profile_tick(eng, tick, layout) -> None:
    """One more ingest-only tick, then one rank cycle, under the profiler."""
    _profiled(f"{layout} ingest tick", lambda: eng.step(*tick))
    _profiled(f"{layout} rank cycle", eng.run_rank_cycle)


def state_bits_equal(a, b) -> bool:
    """``state_arrays()`` of two engines, compared byte for byte."""
    sa, sb = a.state_arrays(), b.state_arrays()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and sa[k].tobytes() == sb[k].tobytes()
        for k in sa)


def run_main_path(dev, ticks, extra_tick, scfg, layout, stream):
    """Phase 4 for one cooc layout: drive the path, check and report it.
    Returns the launch counts of the driven path and a copy of its query
    store as the timed ticks left it."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import topk_select as ktk
    cfg, _ = deployment_config(layout)
    torch.cuda.reset_peak_memory_stats()
    by_route = dict(ktk.ROUTE_LAUNCHES)
    rr_route = dict(ktk.REGION_ROUTE_LAUNCHES)
    sg_route = dict(ktk.SCORE_ROUTE_LAUNCHES)
    eng, step_ms, cycle_ms, results, launches = main_path(dev, ticks, layout)
    by_route = {r: n - by_route[r] for r, n in ktk.ROUTE_LAUNCHES.items()}
    rr_route = {r: n - rr_route[r]
                for r, n in ktk.REGION_ROUTE_LAUNCHES.items()}
    sg_route = {r: n - sg_route[r]
                for r, n in ktk.SCORE_ROUTE_LAUNCHES.items()}
    st = eng.state
    q = st.qstore
    qstore = q._replace(key_hi=q.key_hi.clone(), key_lo=q.key_lo.clone(),
                        lanes={k: v.clone() for k, v in q.lanes.items()})
    drops = {n: int(getattr(st, n).n_dropped)
             for n in ("qstore", "cooc", "sessions")}
    Q, C = cfg.query_capacity, cfg.cooc_capacity
    live_q, live_c = int(st.qstore.live_count()), int(st.cooc.live_count())
    log(f"  {layout} launches on the main path: {launches}; bucket_topk "
        f"by route {by_route}; region_rank by route {rr_route}; score_gate "
        f"by route {sg_route}")
    if sg_route["vec"] != launches["score_gate"]:
        raise AssertionError(f"{layout} score_gate launches by route: "
                             f"{sg_route}")
    if by_route["row"] != launches["bucket_topk"]:
        raise AssertionError(f"{layout} bucket_topk launches by route: "
                             f"{by_route}")
    if rr_route["row"] != launches["region_rank"]:
        raise AssertionError(f"{layout} region_rank launches by route: "
                             f"{rr_route}")
    log(f"  {layout} n_dropped {drops}; live qstore {live_q}/{Q}, "
        f"cooc {live_c}/{C}")
    if layout == "region":
        t = st.cooc
        held = torch.where(t.chain_region >= 0, t.region_fill[
            torch.clamp(t.chain_region, 0).long()], 0).sum(1)
        depth = torch.bincount((t.chain_region >= 0).sum(1),
                               minlength=t.max_chain + 1).tolist()
        room = t.width * t.max_chain
        n_full = int((held == room).sum())
        log(f"  region: W={t.width}, {t.n_regions} regions, "
            f"c_free_regions={int(t.free_regions())}; directory rows by "
            f"chain depth 0..{t.max_chain}: {depth}; full chains "
            f"({room} pairs): {n_full}; last maintenance "
            f"{eng.last_maintenance}")
    elif any(drops.values()):
        raise AssertionError(f"dropped updates at deployment scale: {drops}")
    if len(results) != 2 or results[-1]["n_suggest"] <= 0:
        raise AssertionError(f"{layout} rank cycles: {results}")
    missing = [n for n in tk.PATH_KERNELS[layout] if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {layout} path: "
                             f"{missing}")
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
    log(f"  {layout} main path: " + json.dumps(main))
    profile_tick(eng, extra_tick, layout)
    for i in range(5):
        q = stream.vocab[i]
        sugg = eng.suggest_fp(stream.tok.query_fp(q), k=4)
        log(f"  {layout} {q!r:24s} -> "
            f"{[(stream.tok.text(d), round(s, 3)) for d, s in sugg]}")
    return launches, qstore


def spelling_job(dev, qstore, tok, stats=None, times=None):
    """The serving loop's periodic spelling job: export the live queries,
    join their fingerprints, look up their texts, run the job. ``times``,
    if given, receives the host-clock ms of each step (the last synced)."""
    import torch
    from repro_torch.core.hashing import join_fp
    from repro_torch.core.spelling import SpellConfig, spelling_cycle
    from repro_torch.core.stores import export_live
    t0 = time.perf_counter()
    exp = export_live(qstore)
    t1 = time.perf_counter()
    fps = join_fp(exp["key_hi"], exp["key_lo"])
    texts = [tok.text(int(f)) for f in fps]
    t2 = time.perf_counter()
    corr = spelling_cycle(fps, texts, exp["weight"], SpellConfig(),
                          device=dev, stats=stats)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if times is not None:
        times.update(export_ms=(t1 - t0) * 1e3, texts_ms=(t2 - t1) * 1e3,
                     spelling_cycle_ms=(t3 - t2) * 1e3)
    return fps, texts, exp["weight"], corr


def run_spelling(dev, qstore, stream):
    """Phase 4's spelling job over the hash path's 17-tick query store,
    with edit_distance's launch count set to 0 just before and read just
    after; then the host share of spelling_cycle (scan_order) timed alone
    and one more job under the profiler. Returns (its launch counts, the
    job's inputs and result)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.spelling import SpellConfig, scan_order
    from repro_torch.kernels import edit_distance as ked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats, times = {}, {}
    by_route = dict(ked.ROUTE_LAUNCHES)
    tk.reset_launches()
    t0 = time.perf_counter()
    fps, texts, weights, corr = spelling_job(dev, qstore, stream.tok, stats,
                                             times)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(tk.LAUNCHES)
    by_route = {r: n - by_route[r] for r, n in ked.ROUTE_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    missing = [n for n in tk.PATH_KERNELS["spelling"] if launches[n] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the spelling job: "
                             f"{missing}")
    if by_route["half"] != launches["edit_distance"]:
        raise AssertionError(f"the spelling job's edit_distance launches "
                             f"by route: {by_route}")
    if not corr:
        raise AssertionError("the spelling job emitted no correction")
    t0 = time.perf_counter()
    scan_order(texts, weights, SpellConfig())
    times["scan_order_ms"] = (time.perf_counter() - t0) * 1e3
    live = {int(f) for f in fps}
    planted = [(int(stream.fps[v]), int(stream.fps[t]))
               for v, t in stream.misspell_of.items()]
    planted_live = [(v, t) for v, t in planted if v in live]
    fixed = sum(corr.get(v, (None,))[0] == t for v, t in planted_live)
    row = {"sources": stats["sources"], "pairs_filtered": stats["pairs"],
           "blocks": stats["blocks"], "largest_batch": stats["largest_batch"],
           "edit_distance_launches": launches["edit_distance"],
           "edit_distance_route_launches": by_route,
           "wall_ms": wall_ms, **times, "corrections": len(corr),
           "peak_mem_gib": peak, "planted_variants": len(planted),
           "planted_variants_live": len(planted_live),
           "planted_variants_corrected": fixed}
    log("  spelling job: " + json.dumps(row))
    for v, t in planted_live[:4]:
        got = corr.get(v)
        log(f"    {stream.tok.text(v)!r} -> "
            f"{stream.tok.text(got[0]) if got else None!r} "
            f"(true form {stream.tok.text(t)!r})")
    _profiled("spelling job", lambda: spelling_job(dev, qstore, stream.tok))
    return launches, (fps, texts, weights, corr)


def recheck_spelling(dev, job, n_src=256, chunk=32) -> None:
    """Re-solve n_src sources (half drawn from the corrected ones) against
    all candidates with the plain version on the card and the JAX
    package's filter and scan written out in numpy; each must give the
    job's entry, or none where the job has none."""
    import numpy as np
    import torch
    from repro_torch.core.spelling import SpellConfig, scan_order
    from repro_torch.kernels import ref
    fps, texts, weights, corr = job
    cfg = SpellConfig()
    order, chars, lens, _ = scan_order(texts, weights, cfg)
    fp_s, w_s = fps[order], weights[order]
    n = len(fp_s)
    rng = np.random.default_rng(SEED)
    pos = {int(f): i for i, f in enumerate(fp_s)}
    fixed = np.array([pos[f] for f in corr])
    pick = rng.choice(fixed, min(len(fixed), n_src // 2), replace=False)
    rest = np.setdiff1d(np.arange(n), pick)
    pick = np.concatenate([pick, rng.choice(rest, n_src - len(pick),
                                            replace=False)])
    chars_d = torch.from_numpy(chars).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    cand = torch.arange(n, device=dev)
    n_entries = 0
    for c0 in range(0, len(pick), chunk):
        src = pick[c0:c0 + chunk]
        aa = torch.from_numpy(src).to(dev).repeat_interleave(n)
        bb = cand.repeat(len(src))
        d = ref.edit_distance_ref(chars_d[aa], lens_d[aa], chars_d[bb],
                                  lens_d[bb], cfg.first_char_cost)
        d = d.view(len(src), n).cpu().numpy()
        for k, a in enumerate(src):
            ok = ((w_s >= cfg.freq_boost * w_s[a:a + 1])
                  & (lens[a] >= cfg.min_len)
                  & (np.abs(lens[a] - lens) <= int(cfg.max_distance))
                  & (d[k] > 0.0) & (d[k].astype(np.float64)
                                    <= cfg.max_distance))
            exp = None
            if ok.any():
                b = int(np.argmin(np.where(ok, d[k], np.inf)))
                exp = (int(fp_s[b]), float(d[k][b]))
            got = corr.get(int(fp_s[a]))
            if got != exp:
                raise AssertionError(f"source {a}: job {got}, plain "
                                     f"re-solve {exp}")
            n_entries += exp is not None
    log(f"  plain re-solve of {len(pick)} sources against all {n} "
        f"candidates: {n_entries} corrections, all equal to the job's")


def largest_edit_distance_batch(dev, qstore, tok):
    """An untimed run of the spelling job that keeps the largest pair batch
    passed to edit_distance."""
    from repro_torch.kernels import ops as kops
    largest = {}
    edit_distance = kops.edit_distance

    def spy(ac, al, bc, bl, *, first_char_cost):
        if ac.shape[0] > largest.get("n", -1):
            largest.update(n=ac.shape[0], batch=(ac, al, bc, bl),
                           fc=first_char_cost)
        return edit_distance(ac, al, bc, bl, first_char_cost=first_char_cost)

    kops.edit_distance = spy
    try:
        spelling_job(dev, qstore, tok)
    finally:
        kops.edit_distance = edit_distance
    return largest["batch"], largest["fc"]


def largest_chain_find_batch(dev, ticks):
    """An untimed replay of the region main path's ticks that keeps the
    pair batch with the most active rows passed to chain_find, and the last
    batch of each other row count. Returns the replay's region store, that
    batch (regs, dst_hi, dst_lo, active) and {rows: last batch}."""
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.kernels import ops as kops
    cfg, _ = deployment_config("region")
    largest, by_rows = {}, {}
    chain_find = kops.chain_find

    def spy(khi, klo, regs, dh, dl, active):
        n = int(active.sum())
        batch = tuple(t.clone() for t in (regs, dh, dl, active))
        if n > largest.get("n", -1):
            largest.update(n=n, batch=batch)
        by_rows[regs.shape[0]] = batch
        return chain_find(khi, klo, regs, dh, dl, active)

    kops.chain_find = spy
    try:
        eng = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks:
            eng.step(events, tweets)
    finally:
        kops.chain_find = chain_find
    rows = largest["batch"][0].shape[0]
    return eng.state.cooc, largest["batch"], {
        b: batch for b, batch in by_rows.items() if b != rows}


def last_bucket_topk_grid(dev, ticks, layout):
    """An untimed replay of a main path's ticks that keeps what its last
    bucket_topk call was given: the hash layout's [R, L] bucket grid or
    the region layout's chain-merge candidates, at the last rank cycle.
    Returns (grid, K, the tick of that rank cycle)."""
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.kernels import ops as kops
    cfg, _ = deployment_config(layout)
    calls, ranked, last = [], [], {}
    bucket_topk = kops.bucket_topk

    def spy(grid, k):
        calls.append(k)
        last.update(grid=grid.clone(), k=k)
        return bucket_topk(grid, k)

    kops.bucket_topk = spy
    try:
        eng = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks:
            res = eng.step(events, tweets)
            if res:
                ranked.append(res["tick"])
    finally:
        kops.bucket_topk = bucket_topk
    if len(calls) != len(ranked) or not ranked:
        raise AssertionError(f"{layout} replay: {len(calls)} bucket_topk "
                             f"calls in {len(ranked)} rank cycles")
    return last["grid"], last["k"], ranked[-1]


def last_region_rank_call(dev, ticks):
    """An untimed replay of the region path's ticks that keeps what its last
    region_rank call was given (ops.region_rank's arguments, cloned), at the
    last rank cycle. Returns (args, kwargs, the tick of that rank cycle)."""
    import torch
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.kernels import ops as kops
    cfg, _ = deployment_config("region")
    calls, ranked, last = [], [], {}
    region_rank = kops.region_rank

    def spy(*a, **kw):
        calls.append(kw["k"])
        last.update(call=(tuple(t.clone() if torch.is_tensor(t) else t
                                for t in a), dict(kw)))
        return region_rank(*a, **kw)

    kops.region_rank = spy
    try:
        eng = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks:
            res = eng.step(events, tweets)
            if res:
                ranked.append(res["tick"])
    finally:
        kops.region_rank = region_rank
    if len(calls) != len(ranked) or not ranked:
        raise AssertionError(f"region replay: {len(calls)} region_rank "
                             f"calls in {len(ranked)} rank cycles")
    return last["call"], ranked[-1]


def last_score_gate_call(dev, ticks, eng_out=None):
    """An untimed replay of the hash path's ticks that keeps what its last
    score_gate call was given (ops.score_gate's arguments, cloned), at the
    last rank cycle. Returns (args, kwargs, the tick of that rank cycle);
    ``eng_out`` (a list), if given, receives the replay's engine."""
    import torch
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.kernels import ops as kops
    cfg, _ = deployment_config("hash")
    calls, ranked, last = [], [], {}
    score_gate = kops.score_gate

    def spy(*a, **kw):
        calls.append(1)
        last.update(call=(tuple(t.clone() if torch.is_tensor(t) else t
                                for t in a), dict(kw)))
        return score_gate(*a, **kw)

    kops.score_gate = spy
    try:
        eng = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks:
            res = eng.step(events, tweets)
            if res:
                ranked.append(res["tick"])
    finally:
        kops.score_gate = score_gate
    if len(calls) != len(ranked) or not ranked:
        raise AssertionError(f"hash replay: {len(calls)} score_gate calls in "
                             f"{len(ranked)} rank cycles")
    if eng_out is not None:
        eng_out.append(eng)
    return last["call"], ranked[-1]


def two_runs_bit_identical(dev, ticks, layout) -> None:
    from repro_torch.core.engine import SearchAssistanceEngine
    cfg, _ = deployment_config(layout)
    runs = []
    for _ in range(2):
        e = SearchAssistanceEngine(cfg, device=dev)
        for events, tweets in ticks[:5]:
            e.step(events, tweets)
        runs.append(e)
    if not state_bits_equal(*runs):
        raise AssertionError(f"two {layout} runs of the same stream differ")
    log(f"[5] determinism: two 5-tick {layout} runs (one decay sweep) "
        f"bit-identical")


# ---------------------------------------------------------------------------
# Phase 6: the LM serving path (h2o-danube-1.8b at its published widths).
# ---------------------------------------------------------------------------

LM_ARCH = "h2o-danube-1.8b"
LM_BATCH, LM_SEQ, LM_DECODE = 4, 8192, 16
# Agreement of prefill/decode with the kernel forward, in logits.
# bf16: 8 significant bits, 2^-9 relative per rounding. The two runs round
# at different places (kernel vs plain attention; matmuls over 8208 rows,
# 4096-row chunks or one row) at ~6 sites a layer over 24 layers;
# independent roundings add in quadrature, sqrt(144) x 2^-9 = 2.3% relative
# RMS expected, bounded here at 5%. Logits are ~N(0, 1) (unit-RMS final
# norm, head std 1/sqrt(d)): 2.3% RMS puts 6 sigma over 5e8 logits at
# ~0.14, bounded at 0.5. A wrong cache slot, position or chunk moves logits
# by O(1) and fails both; a mask off by one key of 4096 moves them by
# ~1/4096, which is the f32 check's and the CPU tests' to catch.
LM_BF16_REL_RMS, LM_BF16_MAX_ABS = 0.05, 0.5
# f32 (TF32 off): ~1e-5 relative at worst from sums in another order, so
# ~1e-4 on logits of |x| <= 5. Rounding the logits alone to bf16 errs by up
# to 2^-9 x 4 = 8e-3, and a bf16 computation by ~2e-2 RMS: both fail.
LM_F32_MAX_ABS = 1e-3
# bf16 kernel vs its f32-P twin: the tensor-core kernel rounds each p to
# bf16 once (2^-9 relative); with l summed from the f32 p, the output (a
# weighted mean of v) moves by at most 2^-9 max|v|; rtol 2^-7 covers the
# two final bf16 roundings; relative RMS within 2^-8
# (tests/test_torch_flash_numerics.py derives it on the CPU).
FA_BF16_RTOL, FA_BF16_ATOL_V, FA_BF16_REL_RMS = 2 ** -7, 2 ** -9, 2 ** -8
FA_F32_TOL = dict(rtol=2e-4, atol=2e-4)   # JAX's bar, tests/test_kernels.py


def band_pairs(Tq: int, Tk: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal/window band of one head."""
    import numpy as np
    qpos = np.arange(Tq, dtype=np.int64) + (Tk - Tq)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    hi = np.minimum(Tk, qpos + 1) if causal else Tk
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound(q, k, causal: bool, window: int):
    """Least time for one flash_attention call: the larger of its bytes (q,
    k, v read once, o written once) at the HBM rate and its work, counted
    over the in-band pairs only: 4D FLOPs a pair (q.k and p.v) at the bf16
    tensor-core peak, and one exponential a pair at the SFU rate.
    Returns (ms, "bytes" | "operations", the bounding term, all terms)."""
    B, Hq, Tq, D = q.shape
    pairs = band_pairs(Tq, k.shape[2], causal, window) * B * Hq
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "tensor-core FLOPs": 4 * D * pairs / BF16_TC_OPS_PER_S * 1e3,
             "exponentials": pairs / EXP_PER_S * 1e3}
    which = max(terms, key=terms.get)
    return (terms[which], "bytes" if which == "bytes" else "operations",
            which, dict(terms, pairs=pairs))


def _logit_gap(got, exp):
    """(relative RMS, max abs, top-1 agreement) of two [B, T, V] logit
    tensors, one batch row at a time in f32."""
    sq = ref_sq = mx = 0.0
    same = n = 0
    for g, e in zip(got, exp):
        g, e = g.float(), e.float()
        d = g - e
        sq += float((d * d).sum())
        ref_sq += float((e * e).sum())
        mx = max(mx, float(d.abs().max()))
        same += int((g.argmax(-1) == e.argmax(-1)).sum())
        n += g.shape[0]
    return (sq / ref_sq) ** 0.5, mx, same / n


def lm_scoring(model, cfg, tokens):
    """The scoring forward twice: first untimed, capturing layer 0's q/k/v
    as the kernel receives them; then timed, with the launch counts set to
    0 just before and read just after. Returns (logits, launches, wall ms,
    peak GiB, captured (q, k, v), whether the two are bit-identical)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    captured = []
    kernel_call = ops.flash_attention

    def capture(q, k, v, causal=True, window=0):
        if not captured:
            captured.append((q, k, v))
        return kernel_call(q, k, v, causal, window)

    ops.flash_attention = capture
    try:
        first = tr.forward(model, tokens, cfg)[0]
    finally:
        ops.flash_attention = kernel_call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t0 = time.perf_counter()
    logits = tr.forward(model, tokens, cfg)[0]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return (logits, launches, wall_ms, peak, captured[0],
            torch.equal(first, logits))


def lm_serving(dev, model, cfg, tokens, n_decode, profile_step=False):
    """Prefill the prompts into fresh caches, then ``n_decode`` greedy
    decode steps, with the launch counts set to 0 just before; with
    ``profile_step``, one more (untimed, unchecked) step under the
    profiler. Returns
    (prefill logits, decode logits [B, n, V], the tokens fed to the decode
    steps [B, n], prefill ms, per-step ms, launches, peak GiB)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.models import transformer as tr
    B, T = tokens.shape
    caches = tr.init_caches(cfg, B, T + n_decode, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t0 = time.perf_counter()
    pre, caches = tr.prefill(model, tokens, cfg, caches)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    nxt = pre[:, -1].argmax(-1, keepdim=True).int()
    fed, outs, step_ms = [], [], []
    for _ in range(n_decode):
        fed.append(nxt)
        t0 = time.perf_counter()
        lg, caches = tr.decode_step(model, nxt, cfg, caches)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg)
        nxt = lg.argmax(-1, keepdim=True).int()
    launches = dict(tk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool((caches["pos"] == T + n_decode).all()):
        raise AssertionError("cache positions do not count the tokens")
    if profile_step:
        _profiled("decode step", lambda: tr.decode_step(model, nxt, cfg,
                                                         caches))
    return (pre, torch.stack(outs, 1), torch.cat(fed, 1), prefill_ms,
            step_ms, launches, peak)


def lm_agreement(model, cfg, tokens, pre, dec, fed, max_abs, rel_rms=None):
    """One kernel forward over prompt + fed tokens (ragged on purpose); its
    logits over the prefill's last chunk and at each decode position must
    match the served ones."""
    import torch
    from repro_torch.models import transformer as tr
    T, n = tokens.shape[1], fed.shape[1]
    full = tr.forward(model, torch.cat([tokens, fed], 1), cfg)[0]
    chunk = pre.shape[1]
    for name, got, exp in (("prefill", pre, full[:, T - chunk:T]),
                           ("decode", dec, full[:, T:T + n])):
        rms, mx, top1 = _logit_gap(got, exp)
        log(f"  {name} vs kernel forward over {T + n} tokens "
            f"({got.shape[1]} positions): rel RMS {rms!r}, max abs {mx!r} "
            f"(bounds: rel RMS {rel_rms}, max abs {max_abs}), top-1 "
            f"agreement {top1!r}")
        if mx > max_abs or (rel_rms is not None and rms > rel_rms) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} disagrees with the kernel forward")


def check_flash_attention(q, k, v, window: int):
    """flash_attention on the scoring forward's layer-0 q/k/v (bf16), held
    against its twin one batch row at a time (a row's f32 scores are
    [Hq, T, T]), then an f32 case at a quarter of T. Times: the bare launch,
    the twin row by row (summed) and SDPA with the band as its mask; the
    bf16 kernel must be faster than that SDPA call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, launch
    B, Hq, T, D = q.shape
    got = flash_attention(q, k, v, causal=True, window=window)
    max_v = float(v.float().abs().max())
    tol = dict(rtol=FA_BF16_RTOL, atol=FA_BF16_ATOL_V * max_v)
    err = sq = ref_sq = 0.0
    for b in range(B):
        exp = ref.flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                      causal=True, window=window).float()
        torch.testing.assert_close(got[b:b + 1].float(), exp, **tol)
        d = got[b:b + 1].float() - exp
        err = max(err, float(d.abs().max()))
        sq += float((d * d).sum())
        ref_sq += float((exp * exp).sum())
        del exp, d
    rel_rms = (sq / ref_sq) ** 0.5
    log(f"  flash_attention bf16 q {list(q.shape)}, k/v {list(k.shape)}, "
        f"window {window}: max_abs_err {err!r}, rel RMS {rel_rms!r}, max|v| "
        f"{max_v!r} (bounds: rtol {FA_BF16_RTOL}, atol {FA_BF16_ATOL_V} "
        f"max|v| = {tol['atol']!r}, rel RMS {FA_BF16_REL_RMS}: P is rounded "
        f"to bf16 once)")
    if rel_rms > FA_BF16_REL_RMS:
        raise AssertionError(f"flash_attention bf16 rel RMS {rel_rms}")
    q32, k32, v32 = (t[:1, :, :T // 4].float() for t in (q, k, v))
    got32 = flash_attention(q32, k32, v32, causal=True, window=window)
    exp32 = ref.flash_attention_ref(q32, k32, v32, causal=True,
                                    window=window)
    torch.testing.assert_close(got32, exp32, **FA_F32_TOL)
    log(f"  flash_attention f32 q {list(q32.shape)}: max_abs_err "
        f"{float((got32 - exp32).abs().max())!r} (tolerance {FA_F32_TOL}, "
        f"JAX's bar)")
    del q32, k32, v32, got32, exp32
    scale = ref.attention_scale(D)
    out = torch.empty_like(q)
    ms = time_ms(lambda: launch(q, k, v, out, True, window, scale))
    wrapper_ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                 window=window))
    plain_ms = sum(time_ms(lambda: ref.flash_attention_ref(
        q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True, window=window),
        reps=5, warmup=1) for b in range(B))
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    band = (kpos <= qpos) & (kpos > qpos - window)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)
    library_ms = time_ms(sdpa)
    gap = float((sdpa().float() - got.float()).abs().max())
    log(f"  SDPA (library yardstick, timed only): {library_ms!r} ms, max abs "
        f"gap to the kernel {gap!r}; each fused backend alone: "
        f"{json.dumps(sdpa_backends(sdpa))}")
    _profiled("SDPA", sdpa)
    b_ms, b_by, which, terms = attention_bound(q, k, True, window)
    log(f"  flash_attention bound by {which}: {json.dumps(terms)}")
    flops = 4 * D * terms["pairs"]
    log(f"  flash_attention bf16: {ms!r} ms, {100 * b_ms / ms!r}% of bound, "
        f"{flops / ms / 1e9!r} TFLOP/s; SDPA {library_ms!r} ms "
        f"({library_ms / ms!r}x the kernel's time)")
    for line in ptxas_report("flash_attention", "flash_fwd_tc"):
        log(f"  flash_attention bf16 ptxas: {line}")
    if ms >= library_ms:
        raise AssertionError(f"flash_attention bf16 {ms} ms is not faster "
                             f"than SDPA's {library_ms} ms")
    return dict(max_abs_err=err, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def ptxas_report(stem: str, kernel: str):
    """The ``-Xptxas -v`` lines (entry, registers, spills) of the entry
    functions of ``csrc/<stem>.cu`` whose names contain ``kernel``."""
    from repro_torch.kernels import build
    out, inside = [], False
    for line in build.build_log(stem).splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        if inside and any(w in line for w in ("entry function", "registers",
                                              "spill")):
            out.append(line.strip())
    return out


def sdpa_backends(fn):
    """ms of ``fn`` (an SDPA call) with each fused backend alone, to tell
    which one the default call took; a backend that refuses the inputs
    raises RuntimeError and is reported as refused. The math backend is
    not tried: its [B, H, T, T] scores would not fit."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        with sdpa_kernel(backend):
            try:
                out[backend.name] = time_ms(fn)
            except RuntimeError as e:
                out[backend.name] = "refused: " + str(e).splitlines()[0][:80]
    return out


def small_lm(dev) -> None:
    """Phase 3 for the LM: each SMOKE model (f32, TF32 off) on the card
    against the same weights on the CPU: the forward (kernel against twin),
    then prefill of 64 tokens and 4 greedy decode steps; logits within
    1e-4 (f32 sums in another order)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("h2o-danube-1.8b", "granite-3-8b", "qwen3-8b"):
        cfg = get_arch(arch).smoke_config
        cpu = tr.init_params(cfg, generator=torch.Generator().manual_seed(SEED),
                             device="cpu")
        card = tr.init_params(cfg,
                              generator=torch.Generator().manual_seed(SEED),
                              device="cpu").to(dev)
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))
        pairs = [(tr.forward(card, toks.to(dev), cfg)[0],
                  tr.forward(cpu, toks, cfg)[0])]
        caches = [tr.init_caches(cfg, 2, 68, device=d) for d in (dev, "cpu")]
        gl, caches[0] = tr.prefill(card, toks.to(dev), cfg, caches[0])
        cl, caches[1] = tr.prefill(cpu, toks, cfg, caches[1])
        pairs.append((gl, cl))
        nxt = cl[:, -1:].argmax(-1).int()
        for _ in range(4):
            gl, caches[0] = tr.decode_step(card, nxt.to(dev), cfg, caches[0])
            cl, caches[1] = tr.decode_step(cpu, nxt, cfg, caches[1])
            pairs.append((gl, cl))
            nxt = cl.argmax(-1, keepdim=True).int()
        err = 0.0
        for g, c in pairs:
            torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)
            err = max(err, float((g.cpu() - c).abs().max()))
        log(f"  {arch} SMOKE, card vs CPU: forward, prefill and 4 decode "
            f"steps, max abs logit error {err!r} (tolerance 1e-4)")


def run_lm(dev, rows):
    """Phase 6 (with the LM's parts of phases 2 and 5): h2o-danube-1.8b at
    its published widths and depth, bf16, random weights from a seeded
    generator on the card. Returns the scoring forward's launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels as tk
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH).config
    B, T, n_dec = LM_BATCH, LM_SEQ, LM_DECODE
    t0 = time.perf_counter()
    model = tr.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[6] LM serving path: {cfg}, {n_params} parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), made in "
        f"{time.perf_counter() - t0:.3f} s")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        logits, launches, wall, peak, (q, k, v), same = lm_scoring(
            model, cfg, tokens)
        missing = [n for n in tk.PATH_KERNELS["lm"] if launches[n] <= 0]
        if missing or launches["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"scoring forward launches {launches}")
        if logits.shape != (B, T, cfg.padded_vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("scoring logits not finite or misshapen")
        log(f"  scoring forward: {B} x {T} tokens in {wall!r} ms "
            f"({B * T / wall * 1e3!r} tokens/s), peak {peak!r} GiB, "
            f"flash_attention launches {launches['flash_attention']}")
        if not same:
            raise AssertionError("two scoring forwards differ")
        log("[5] determinism: two scoring forwards give bit-identical logits")
        del logits
        _profiled("scoring forward", lambda: tr.forward(model, tokens, cfg))
        pre, dec, fed, pre_ms, step_ms, s_launches, s_peak = lm_serving(
            dev, model, cfg, tokens, n_dec, profile_step=True)
        log(f"  serving: prefill {B} x {T} in chunks of "
            f"{cfg.window or T}: {pre_ms!r} ms; {n_dec} decode steps, ms "
            f"each {step_ms!r} (median {statistics.median(step_ms)!r}); "
            f"peak {s_peak!r} GiB; flash_attention launches "
            f"{s_launches['flash_attention']} (prefill and decode read the "
            f"cache in plain torch)")
        lm_agreement(model, cfg, tokens, pre, dec, fed, LM_BF16_MAX_ABS,
                     LM_BF16_REL_RMS)
        del pre, dec
        torch.cuda.empty_cache()
        log("[2] flash_attention at the scoring forward's layer-0 shapes")
        rows["flash_attention"] = check_flash_attention(q, k, v, cfg.window)
        log(f"  flash_attention at its main-path shape: "
            f"{json.dumps(rows['flash_attention'])}")
        del q, k, v
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[6] f32: allow_tf32 matmul "
            f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
            f"{torch.backends.cudnn.allow_tf32}; B=1, T={T}, prefill and 4 "
            f"decode steps against the kernel forward")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = model.float()
        pre, dec, fed, _, _, _, _ = lm_serving(dev, model, cfg32,
                                               tokens[:1], 4)
        lm_agreement(model, cfg32, tokens[:1], pre, dec, fed,
                     LM_F32_MAX_ABS)
    del model
    torch.cuda.empty_cache()
    log(f"  LM phases took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: crash recovery at deployment scale.
# ---------------------------------------------------------------------------

RECOVERY_TICKS = 21          # ticks 0..19 stepped, tick 20 torn by the crash
RECOVERY_TPS = 4             # ticks per log segment


def arrays_bits_equal(a, b) -> bool:
    """Two ``state_arrays()`` dicts, leaf for leaf, byte for byte."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


def recovery_cell(dev, ticks, layout, root: Path):
    """Phase 7 for one cooc layout: a live run that logs every tick and
    snapshots at each rank cycle (full, then delta), a crash that tears
    tick 20, then two recoveries (the newest chain; the full alone) held
    bit for bit against the state after tick 19, with equal suggestions.
    Returns (report dict, the recoveries' summed launch counts)."""
    import torch
    from repro_torch import kernels as tk
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.streaming import (FirehoseLogReader, FirehoseLogWriter,
                                       ReplayConfig, kill_writer_mid_segment,
                                       recover_engine)
    cfg, scfg = deployment_config(layout)
    ckpt = CheckpointManager(str(root / "ckpt"), keep_n=0, full_interval=2)
    log_dir = str(root / "log")
    writer = FirehoseLogWriter(log_dir, ticks_per_segment=RECOVERY_TPS)
    eng = SearchAssistanceEngine(cfg, device=dev)
    saves, step_ms = [], []
    for t, (events, tweets) in enumerate(ticks[:RECOVERY_TICKS - 1]):
        writer.append(t, events, tweets)
        t0 = time.perf_counter()
        out = eng.step(events, tweets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if out is None:
            continue
        t0 = time.perf_counter()
        eng.save_snapshot(ckpt)
        wall = (time.perf_counter() - t0) * 1e3
        saves.append({"step": int(eng.state.tick),
                      "kind": ckpt.last_save_kind,
                      "raw_bytes": ckpt.last_save_raw_bytes,
                      "disk_bytes": ckpt.last_save_bytes, "wall_ms": wall,
                      "split_ms": ckpt.last_save_ms})
    if [s["kind"] for s in saves] != ["full", "delta"]:
        raise AssertionError(f"{layout} snapshots: {saves}")
    reference = eng.state_arrays()           # host copies of the card state
    del eng
    torch.cuda.empty_cache()
    writer.append(RECOVERY_TICKS - 1, *ticks[RECOVERY_TICKS - 1])
    torn = kill_writer_mid_segment(writer)
    reader = FirehoseLogReader(log_dir)
    if torn is None or reader.last_tick() != RECOVERY_TICKS - 2 or \
            reader.n_unmanifested_files != 1:
        raise AssertionError(f"{layout} torn tail: {torn}, head "
                             f"{reader.last_tick()}")
    ref = SearchAssistanceEngine(cfg, device=dev)
    ref.load_state_arrays(reference)
    ref.run_rank_cycle()
    ref_suggestions = ref.suggestions
    del ref
    torch.cuda.empty_cache()
    full_step = saves[0]["step"]
    launches = {n: 0 for n in tk.KERNELS}
    runs = {}
    for label, step, tail in (("a", None, RECOVERY_TICKS - 1 - saves[1]["step"]),
                              ("b", full_step, RECOVERY_TICKS - 1 - full_step)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launches()
        t0 = time.perf_counter()
        rec, stats = recover_engine(cfg, ckpt, log_dir, ReplayConfig(),
                                    step=step, device=dev)
        torch.cuda.synchronize()
        fresh_ms = (time.perf_counter() - t0) * 1e3
        for n, k in tk.LAUNCHES.items():
            launches[n] += k
        peak = torch.cuda.max_memory_allocated() / 2**30
        if stats["n_ticks"] != tail or int(rec.state.tick) != \
                RECOVERY_TICKS - 1:
            raise AssertionError(f"{layout} recovery ({label}): {stats}")
        if not arrays_bits_equal(rec.state_arrays(), reference):
            raise AssertionError(f"{layout} recovery ({label}) differs from "
                                 f"the uncrashed state")
        if rec.suggestions != ref_suggestions or not rec.suggestions:
            raise AssertionError(f"{layout} recovery ({label}): suggestions "
                                 f"differ from the uncrashed state's")
        replay_s = stats["wall_s"] - stats["rank_s"]
        runs[label] = {
            "restored_step": stats["restored_step"],
            "chain_len": stats["restore"]["chain_len"],
            "ticks_replayed": stats["n_ticks"],
            "time_to_fresh_ms": fresh_ms,
            "restore_ms": stats["restore_s"] * 1e3,
            "restore_split_ms": stats["restore_ms"],
            "replay_ms": replay_s * 1e3,
            "replay_ms_per_tick": replay_s * 1e3 / stats["n_ticks"],
            "replay_x_real_time": stats["n_ticks"] * scfg.tick_seconds
            / replay_s,
            "rank_ms": stats["rank_s"] * 1e3,
            "rank_cycles": stats["n_rank_run"],
            "suggestions": len(rec.suggestions),
            "peak_mem_gib": peak}
        del rec
        torch.cuda.empty_cache()
    report = {"layout": layout, "live_ms_per_tick_mean":
              statistics.mean(step_ms), "rank_period_ms":
              cfg.rank_every * scfg.tick_seconds * 1e3, "saves": saves,
              "torn": torn, "recoveries": runs,
              "launches": {n: k for n, k in launches.items() if k}}
    return report, launches


def run_recovery(dev, card: str):
    """Phase 7: recovery at deployment scale under each cooc layout, then
    the breaking-news scenario on the card. Returns the recovery path's
    launch counts (both layouts summed)."""
    import tempfile
    import torch
    from repro_torch import breaking_news
    from repro_torch import kernels as tk
    from repro_torch.data.stream import SyntheticStream
    t_phase = time.perf_counter()
    _, scfg = deployment_config()
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(RECOVERY_TICKS)]
    total = {n: 0 for n in tk.KERNELS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recovery_") as tmp:
        for layout in ("hash", "region"):
            report, launches = recovery_cell(dev, ticks, layout,
                                             Path(tmp) / layout)
            missing = [n for n in tk.PATH_KERNELS[layout] if launches[n] <= 0]
            if missing:
                raise AssertionError(f"kernels not launched on the {layout} "
                                     f"recovery path: {missing}")
            for n, k in launches.items():
                total[n] += k
            log(f"[7] {layout} recovery ({card}): " + json.dumps(report))
            for s in report["saves"]:
                log(f"  {layout} save step {s['step']} ({s['kind']}): "
                    f"{s['raw_bytes']} B raw, {s['disk_bytes']} B on disk, "
                    f"{s['wall_ms']:.3f} ms against a rank period of "
                    f"{report['rank_period_ms']:.0f} ms; split "
                    + ", ".join(f"{k} {v:.3f}" for k, v in
                                s["split_ms"].items()))
            for label, r in report["recoveries"].items():
                log(f"  {layout} recovery ({label}) from step "
                    f"{r['restored_step']} (chain of {r['chain_len']}): "
                    f"bit-exact, suggestions equal; time to fresh "
                    f"{r['time_to_fresh_ms']:.3f} ms = restore "
                    f"{r['restore_ms']:.3f} + replay {r['ticks_replayed']} "
                    f"ticks {r['replay_ms']:.3f} "
                    f"({r['replay_ms_per_tick']:.3f} ms a tick, "
                    f"{r['replay_x_real_time']:.1f}x real time) + rank "
                    f"{r['rank_ms']:.3f}; restore split "
                    + ", ".join(f"{k} {v:.3f}" for k, v in
                                r["restore_split_ms"].items())
                    + f"; peak {r['peak_mem_gib']:.3f} GiB")
            log(f"  {layout} recovery launches: {report['launches']}")
            torch.cuda.empty_cache()
        log("[7] breaking news on the card (python -m "
            "repro_torch.breaking_news)")
        lines = []
        t0 = time.perf_counter()
        res = breaking_news.run(dev, out_dir=str(Path(tmp) / "news"),
                                log=lines.append)
        wall = time.perf_counter() - t0
    for line in lines:
        if "CRASH" in line or ">>>" in line or "breaks at" in line:
            log("  " + line.strip())
    rec = res["recovery"]
    if res["latency_min"] is None or \
            res["latency_min"] > breaking_news.TARGET_MIN:
        raise AssertionError(f"breaking news: related terms surfaced after "
                             f"{res['latency_min']} sim-min")
    if not res["kept"] or not any(t in dict(res["final"])
                                  for t in res["event_terms"]):
        raise AssertionError(f"breaking news: event terms lost across the "
                             f"crash: {res['final']}")
    log(f"  breaking news ({card}): surfaced {res['latency_min']} sim-min "
        f"after the event (target {breaking_news.TARGET_MIN}); crash "
        f"recovery from step {rec['restored_step']}, {rec['n_ticks']} ticks "
        f"replayed, {rec['wall_total_s'] * 1e3:.3f} ms wall; kept "
        f"{res['kept']}; final {res['final']}; scenario {wall:.1f} s")
    log(f"  recovery phase took {time.perf_counter() - t_phase:.1f} s")
    return total


def profile_region() -> None:
    """The region cell's 17 ticks, then one more ingest tick and one rank
    cycle under the profiler, on the ``repro_torch`` package on the path."""
    import torch
    import repro_torch
    from repro_torch.core.engine import SearchAssistanceEngine
    from repro_torch.data.stream import SyntheticStream
    log(f"profile region: {card_line()} | package "
        f"{Path(repro_torch.__file__).parent}")
    cfg, scfg = deployment_config("region")
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(18)]
    eng = SearchAssistanceEngine(cfg, device=torch.device("cuda"))
    for events, tweets in ticks[:17]:
        eng.step(events, tweets)
    profile_tick(eng, ticks[17], "region")


def profile_hash() -> None:
    """The hash cell's 17 ticks (score_gate's last arguments kept by a spy),
    then one more ingest tick and one rank cycle under the profiler, then
    score_gate's and assoc_score's bare launches timed on the synthetic
    lanes and on those kept lanes, on the ``repro_torch`` package on the
    path (launch signatures shared with the parent trees)."""
    import torch
    import repro_torch
    from repro_torch.core.ranking import RankConfig
    from repro_torch.data.stream import SyntheticStream
    from repro_torch.kernels import assoc_score as kas
    from repro_torch.kernels import topk_select as ktk
    dev = torch.device("cuda")
    log(f"profile hash: {card_line()} | package "
        f"{Path(repro_torch.__file__).parent}")
    cfg, scfg = deployment_config("hash")
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(18)]
    eng = []
    (a, kw), tick = last_score_gate_call(dev, ticks[:17], eng)
    profile_tick(eng[0], ticks[17], "hash")
    del eng
    rc = RankConfig()
    gates = (rc.min_pair_weight, rc.min_src_weight, rc.min_pair_count)
    syn, ok, lt, sc = _score_inputs(cfg.cooc_capacity, dev)
    cases = {"synthetic lanes": (syn, ok, torch.stack(sc)),
             f"hash path lanes, tick {tick}": (a[:6], a[6], torch.stack(
                 [x.to(torch.float32).reshape(()) for x in a[7:9]]
                 + [torch.zeros((), device=dev)]))}
    for label, (lanes, g, scalars) in cases.items():
        out = torch.empty_like(lanes[0])
        ms = {"score_gate": time_ms(lambda: ktk.launch_score_gate(
            lanes, g, None, scalars, kw["coefs"], gates, None, out))}
        if label == "synthetic lanes":
            ms["score_gate lazy"] = time_ms(lambda: ktk.launch_score_gate(
                lanes, g, lt.data_ptr(), scalars, kw["coefs"], gates, 36.0,
                out))
        ms["assoc_score"] = time_ms(lambda: kas.launch_assoc_score(
            lanes, scalars[:2], kw["coefs"], out))
        log(f"  profile hash, bare launches on the {label}: "
            + ", ".join(f"{k} {v!r} ms" for k, v in ms.items()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-region-only", action="store_true",
                    help="profile the region cell's ingest tick and rank "
                         "cycle, and nothing else")
    ap.add_argument("--profile-hash-only", action="store_true",
                    help="profile the hash cell's ingest tick and rank "
                         "cycle and time score_gate and assoc_score, and "
                         "nothing else")
    ap.add_argument("--root", default=str(ROOT),
                    help="with --profile-region-only or --profile-hash-only:"
                         " a directory inside this checkout whose "
                         "src/repro_torch is profiled")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    profile = args.profile_region_only or args.profile_hash_only
    if root != ROOT and not (profile and root.is_relative_to(ROOT)):
        print("chip_smoke: --root takes a directory inside this checkout, "
              "with --profile-region-only or --profile-hash-only",
              file=sys.stderr)
        return 2
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    if args.profile_region_only:
        profile_region()
    if args.profile_hash_only:
        profile_hash()
    if profile:
        return 0
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
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  {stem}: {line.strip()}")

    # ---- 2. kernels at main-path shapes ----
    cfg, _ = deployment_config()
    rcfg, _ = deployment_config("region")
    C, Q = cfg.cooc_capacity, cfg.query_capacity
    R = min(Q, int(C * cfg.rank.seg_arena_frac))
    L, K = max(cfg.rank.bucket_rows, cfg.rank.top_k), cfg.rank.top_k
    RW = rcfg.region_w
    log(f"[2] kernels vs plain versions: cooc C={C}, qstore C={Q}, "
        f"grid {R}x{L}, K={K}; region grid {C // RW}x{RW}, "
        f"K1={min(K, RW)}")
    rows = {}
    rows["decay_prune_multi"] = check_decay_prune(C, 6, dev)
    q_row = check_decay_prune(Q, 2, dev)
    log(f"  decay_prune_multi qstore C={Q}: {json.dumps(q_row)}")
    floor = score_floor()
    rows["score_gate"] = check_score_gate(C, dev, floor)
    rows["bucket_topk"] = check_bucket_topk(R, L, K, dev)
    rows["region_rank"] = check_region_rank(C // RW, RW, min(K, RW), dev,
                                            floor)
    rows["assoc_score"] = check_assoc_score(C, dev, floor)
    for name, row in rows.items():
        log(f"  {name} at its main-path shape: {json.dumps(row)}")
    torch.cuda.empty_cache()

    # ---- 3. card vs CPU at a small size ----
    log("[3] engine on the card vs engine on the CPU (test_engine stream)")
    small_spelling(dev, small_parity(dev)[1])
    small_parity(dev, "region")
    small_parity(dev, "region", lazy=True)
    t0 = time.perf_counter()
    log("[3] LM SMOKE models on the card vs the CPU")
    small_lm(dev)
    log(f"  LM SMOKE parity took {time.perf_counter() - t0:.1f} s")

    # ---- 4. main paths at deployment scale ----
    from repro_torch.data.stream import SyntheticStream
    _, scfg = deployment_config()
    n_ticks = 17
    t0 = time.perf_counter()
    stream = SyntheticStream(scfg, seed=SEED)
    ticks = [stream.gen_tick(t) for t in range(n_ticks)]
    extra_tick = stream.gen_tick(n_ticks)
    log(f"[4] main paths: {n_ticks} ticks of {scfg.queries_per_tick} "
        f"queries + {scfg.tweets_per_tick} tweets; stream generated in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    for layout in ("hash", "region"):
        launches[layout], qstore = run_main_path(dev, ticks, extra_tick, scfg,
                                                 layout, stream)
        torch.cuda.empty_cache()
        if layout != "hash":
            continue
        log(f"[4] spelling job over the hash path's {n_ticks}-tick qstore")
        launches["spelling"], job = run_spelling(dev, qstore, stream)
        recheck_spelling(dev, job)
        for _ in range(2):
            again = spelling_job(dev, qstore, stream.tok)[3]
            if list(again.items()) != list(job[3].items()):
                raise AssertionError("two spelling jobs differ")
        log(f"[5] determinism: the spelling job twice more, "
            f"{len(job[3])} corrections, same items in the same order")
        log("[2] edit_distance at the spelling job's shapes (untimed run)")
        batch, fc = largest_edit_distance_batch(dev, qstore, stream.tok)
        rows["edit_distance"] = check_edit_distance(batch, fc)
        log(f"  edit_distance at its main-path shape: "
            f"{json.dumps(rows['edit_distance'])}")
        del qstore, job, batch
        torch.cuda.empty_cache()
    log("[2] chain_find at the region run's shapes (untimed replay of its "
        "ticks)")
    table, batch, others = largest_chain_find_batch(dev, ticks)
    rows["chain_find"] = check_chain_find(table, batch, dev)
    rows["chain_find"]["other_batches"] = [
        check_chain_find_batch(table, b) for b in others.values()]
    log(f"  chain_find at its main-path shape: "
        f"{json.dumps(rows['chain_find'])}")
    del table, batch, others
    torch.cuda.empty_cache()
    log("[2] region_rank at the region path's own grid (untimed replay of "
        "its ticks, the last rank cycle)")
    call, tick = last_region_rank_call(dev, ticks)
    rows["region_rank"]["path_grid"] = check_region_rank_path_grid(
        call, tick, floor)
    log(f"  region_rank at the region path's grid: "
        f"{json.dumps(rows['region_rank']['path_grid'])}")
    del call
    torch.cuda.empty_cache()
    log("[2] score_gate and assoc_score on the hash path's own lanes "
        "(untimed replay of its ticks, the last rank cycle)")
    call, tick = last_score_gate_call(dev, ticks)
    path_lanes = check_score_path_lanes(call, tick, floor)
    for name in ("score_gate", "assoc_score"):
        rows[name]["path_lanes"] = path_lanes[name]
        log(f"  {name} at the hash path's lanes: "
            f"{json.dumps(path_lanes[name])}")
    del call
    torch.cuda.empty_cache()
    log("[2] bucket_topk at the main paths' own grids (untimed replays of "
        "their ticks, the last rank cycle)")
    path_grids = {}
    for layout, what in (("hash", "hash bucket grid"),
                         ("region", "region chain-merge candidates")):
        grid, k, tick = last_bucket_topk_grid(dev, ticks, layout)
        path_grids[layout] = check_bucket_topk_path_grid(
            f"{what}, tick {tick}", grid, k)
        log(f"  bucket_topk at the {layout} path's grid: "
            f"{json.dumps(path_grids[layout])}")
        del grid
        torch.cuda.empty_cache()
    rows["bucket_topk"]["path_grids"] = path_grids

    # ---- 5. determinism ----
    two_runs_bit_identical(dev, ticks, "hash")
    two_runs_bit_identical(dev, ticks, "region")

    # ---- 6. the LM serving path at full width ----
    launches["lm"] = run_lm(dev, rows)

    # ---- 7. crash recovery at deployment scale ----
    launches["recovery"] = run_recovery(dev, card)
    log("kernels " + " ".join(f"{n}=ok" for n in rows))

    sources = {"decay_prune_multi": ("decay_prune.cu", "decay_prune.py:85"),
               "score_gate": ("score_gate.cu", "topk_select.py:78"),
               "bucket_topk": ("bucket_topk.cu", "topk_select.py:150"),
               "chain_find": ("chain_find.cu", "region_probe.py:50"),
               "region_rank": ("region_rank.cu", "topk_select.py:236"),
               "assoc_score": ("assoc_score.cu", "assoc_score.py:81"),
               "edit_distance": ("edit_distance.cu", "edit_distance.py:107"),
               "flash_attention": ("flash_attention.cu",
                                   "flash_attention.py:86")}
    record = {"kernels": [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{sources[n][0]}",
         "replaces": f"src/repro/kernels/{sources[n][1]}",
         "launches": sum(launches[p][n] for p in launches),
         "launches_by_path": {p: launches[p][n] for p in launches},
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

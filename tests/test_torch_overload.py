"""The PyTorch port's workload generator and overload control, on the CPU.

Against the JAX package: ``FirehoseWorkload.gen_tick`` (spike and spam
ticks included), ``bucket_size`` and ``_mix64`` bit for bit; the ladder's
levels and counters on seeded signal sequences; ``admit_events`` /
``admit_tweets`` arrays and shed counts at every level; and an
``AssistanceService(slo=...)`` under one forced schedule (batching
included), both layouts, held against JAX's in both engines' states
(leaf for leaf, under the parity contract of ``torch_parity.py``), in the
controller's counters and in the log's admitted ticks.

The port against itself (the cases of ``tests/test_overload.py``):
batched == per-tick, shed accounting at every level, a mid-shed crash
recovered bit for bit, slow I/O plus a torn writer during a spike, the
frontend's overload metrics, the legacy path, and mirrors equal to the
leader after a spike. No test reads a wall clock.
"""
import time

import numpy as np
import pytest
import torch

from repro.core.background import AssistanceService as JService
from repro.core.decay import DecayConfig as JDecayConfig
from repro.core.engine import EngineConfig as JEngineConfig
from repro.data.stream import QueryEvents as JQueryEvents
from repro.data.stream import TweetBatch as JTweetBatch
from repro.streaming import FirehoseLogReader as JLogReader
from repro.streaming import FirehoseLogWriter as JLogWriter
from repro.streaming import overload as joverload
from repro.streaming import workload as jworkload
from repro_torch.core.background import AssistanceService
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import (EngineConfig, SearchAssistanceEngine,
                                     rank_due)
from repro_torch.data.stream import QueryEvents, TweetBatch
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.serving.serve import SuggestFrontend, pack_suggestions
from repro_torch.streaming import (FirehoseLogReader, FirehoseLogWriter,
                                   ReplayConfig, SLOConfig, admit_events,
                                   admit_tweets, bucket_size,
                                   kill_writer_mid_segment, recover_service,
                                   slow_io)
from repro_torch.streaming import workload
from repro_torch.streaming.overload import DegradationLadder
from torch_parity import compare_states

CPU = torch.device("cpu")
CFG = dict(query_capacity=1 << 11, cooc_capacity=1 << 13,
           session_capacity=1 << 10, session_window=3, decay_every=4,
           prune_every=6, rank_every=5, region_width=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread under the tier-1 run's worker processes,
    restored after the module (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(policy="lazy", **kw):
    return EngineConfig(**{**CFG, **kw}, decay=DecayConfig(policy=policy))


def _jcfg(policy="lazy", **kw):
    return JEngineConfig(**{**CFG, **kw}, decay=JDecayConfig(policy=policy))


def _wl_cfg(spike_mult=50.0, spike_at=6, **kw):
    """The JAX tests' small workload (tests/test_overload.py)."""
    base = dict(vocab_per_lang=128, n_langs=3, n_users=500,
                base_queries_per_tick=64, base_tweets_per_tick=8,
                min_bucket=64, min_tweet_bucket=8,
                spikes=(dict(t_start=spike_at, mult=spike_mult),),
                spam=dict(period=9, burst_ticks=2))
    base.update(kw)
    return base


def _build(mod, seed, cfg):
    """A workload of package ``mod`` from a plain description."""
    cfg = dict(cfg)
    cfg["spikes"] = tuple(mod.SpikeSpec(**s) for s in cfg["spikes"])
    if cfg["spam"] is not None:
        cfg["spam"] = mod.SpamSpec(**cfg["spam"])
    return mod.FirehoseWorkload(mod.WorkloadConfig(**cfg), seed=seed)


def _wl(seed=3, **kw):
    return _build(workload, seed, _wl_cfg(**kw))


def _slo(**kw):
    """Thresholds pushed out of reach by default — tests that need ladder
    movement either force levels or pass explicit triggers."""
    base = dict(slo_ms=1e9, up_lag=1e9, compact_min=16)
    base.update(kw)
    return SLOConfig(**base)


def _bits_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _arrays_equal(xs, ys):
    for x, y in zip(xs, ys):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


# ---------------------------------------------------------------------------
# Workload generator against JAX
# ---------------------------------------------------------------------------

# ticks 0-5 calm (spam bursts at 0, 1), the spike from 6 (peak ~8-16),
# spam bursts at 9, 10, 18, 19 inside it, the die-off after 16
@pytest.mark.parametrize("seed,spike_mult", [(0, 50.0), (3, 8.0), (9, 0.0)])
def test_gen_tick_matches_jax(seed, spike_mult):
    cfg = _wl_cfg(spike_mult=spike_mult)
    j, t = _build(jworkload, seed, cfg), _build(workload, seed, cfg)
    assert t.vocab == j.vocab
    _arrays_equal([t.fps, t.topic, t._ph, t.spam_idx],
                  [j.fps, j.topic, j._ph, j.spam_idx])
    for tick in (0, 1, 4, 6, 7, 9, 10, 14, 18, 19, 25, 40):
        (tev, ttw), (jev, jtw) = t.gen_tick(tick), j.gen_tick(tick)
        _arrays_equal(tev, jev)
        _arrays_equal(ttw, jtw)
        assert t.volume_mult(tick) == j.volume_mult(tick)
    # the ticks above hold a spike at ~50x, spam bursts and calm ticks
    assert spike_mult == 0.0 or t.volume_mult(14) > 4.0
    assert t.spam_mult(18) > 0.0 and t.spam_mult(4) == 0.0


def test_bucket_size_and_mix64_match_jax():
    for n in (0, 1, 63, 64, 65, 255, 256, 1000, 4096, 10_000, 1 << 20):
        for lo, hi, f in ((64, 4096, 4), (256, 1 << 14, 4), (1, 1 << 11, 2)):
            assert bucket_size(n, lo, hi, f) == \
                jworkload.bucket_size(n, lo, hi, f)
    x = np.random.default_rng(0).integers(0, 2**64 - 1, 4096,
                                          dtype=np.uint64)
    x[:3] = (0, 1, 2**64 - 1)
    _arrays_equal([workload._mix64(x)], [jworkload._mix64(x)])


def test_workload_spike_scales_volume_and_spam_comes_from_bots():
    """The JAX tests' structure checks on the port's generator: a ~50x
    crowd in power-of-4 buckets that asks about the event, spam from a
    small bot pool."""
    wl = _wl(seed=9)
    calm = int(wl.gen_tick(4)[0].valid.sum())
    ev, _ = wl.gen_tick(14)
    assert int(ev.valid.sum()) > 30 * calm
    shapes = {wl.gen_tick(t)[0].q_fp.shape for t in range(0, 30)}
    assert len(shapes) <= 4, shapes
    spike_fps = np.array(sorted(int(wl.fps[i]) for i in wl.spike_terms[0]),
                         np.uint64)
    assert np.isin(ev.q_fp[ev.valid], spike_fps).mean() > 0.4
    ev_s, _ = wl.gen_tick(18)
    spam = np.isin(ev_s.q_fp[ev_s.valid],
                   np.array(sorted(int(wl.fps[i]) for i in wl.spam_idx),
                            np.uint64))
    assert spam.any()
    assert len(np.unique(ev_s.sess_fp[ev_s.valid][spam])) <= 8


# ---------------------------------------------------------------------------
# Ladder and admission against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ladder_matches_jax(seed):
    """Seeded sequences of lag, p95 and free fraction (None included),
    a forced stretch in the middle: the same level at every observation
    and the same counters."""
    rng = np.random.default_rng(seed)
    kw = dict(up_lag=float(rng.uniform(2, 6)), down_lag=1.0,
              up_ticks=int(rng.integers(1, 4)),
              down_ticks=int(rng.integers(1, 7)), slo_ms=50.0,
              freelist_min=0.05)
    t, j = DegradationLadder(SLOConfig(**kw)), \
        joverload.DegradationLadder(joverload.SLOConfig(**kw))
    for i in range(300):
        if i == 150:
            t.force(3)
            j.force(3)
        if i == 170:
            t.force(None)
            j.force(None)
        sig = dict(lag=float(rng.choice([0.0, 0.5, 1.0, 3.0, 8.0])),
                   p95_ms=[None, float(rng.uniform(0, 100))][rng.integers(2)],
                   free_frac=[None, float(rng.uniform(0, 0.2))][
                       rng.integers(2)])
        assert t.observe(**sig) == j.observe(**sig), i
        assert t.name == j.name
    assert (t.level_ticks, t.n_escalations, t.n_deescalations) == \
        (j.level_ticks, j.n_escalations, j.n_deescalations)
    assert t.n_escalations > 0 and t.n_deescalations > 0


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("tail_src,tail_keep", [(2, 0.1), (0, 0.5), (1, 0.9)])
def test_admission_matches_jax(level, tail_src, tail_keep):
    rng = np.random.default_rng(level * 7 + tail_src)
    B, T = 256, 32
    src = np.where(np.arange(B) % 8 == 0, rng.integers(0, 2, B),
                   rng.integers(0, 3, B)).astype(np.int32)
    arrs = (rng.integers(1, 2**63, B).astype(np.uint64),
            rng.integers(1, 2**63, B).astype(np.uint64), src,
            np.arange(B) < 200)
    grams = (rng.integers(1, 2**63, (T, 4)).astype(np.uint64),
             rng.random(T) < 0.7)
    kw = dict(tail_src=tail_src, tail_keep=tail_keep, compact_min=16)
    tcfg, jcfg = SLOConfig(**kw), joverload.SLOConfig(**kw)
    got, shed = admit_events(QueryEvents(*arrs), level, tcfg)
    exp, jshed = joverload.admit_events(JQueryEvents(*arrs), level, jcfg)
    assert shed == jshed and (shed > 0) == (level == 3)
    _arrays_equal(got, exp)
    tw, tshed = admit_tweets(TweetBatch(*grams), level, tcfg)
    jtw, jtshed = joverload.admit_tweets(JTweetBatch(*grams), level, jcfg)
    assert tshed == jtshed and (tw is None) == (jtw is None)
    if tw is not None:
        _arrays_equal(tw, jtw)
    assert admit_events(None, level, tcfg) == (None, 0)


# ---------------------------------------------------------------------------
# The service under one forced schedule, against JAX
# ---------------------------------------------------------------------------

SCHEDULE = (0, 0, 0, 1, 1, 2, 2, 3, 3, 3, 3, 1, 0, 0)
LAGS = (0, 0, 3, 3, 3, 0, 0, 5, 5, 5, 0, 2, 0, 0)


def _forced_run(svc, wl, writer, lag_hints=LAGS):
    for t, level in enumerate(SCHEDULE):
        svc.overload.ladder.force(level)
        svc.step(*wl.gen_tick(t), log_append=writer.append,
                 lag_hint=float(lag_hints[t]))
    svc.drain()
    writer.close()


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_service_matches_jax_under_forced_schedule(tmp_path, layout):
    """Every rung, lag-driven batching (fused flushes of up to 8 ticks):
    the port's service equals JAX's in both engines' states, in every
    counter of ``stats_snapshot()`` (latencies aside), in the free-region
    fraction the region layout feeds the ladder, and in the admitted
    ticks of the log."""
    # calm traffic keeps the micro-batch shapes (and JAX's compiles) few
    wcfg = _wl_cfg(spike_mult=0.0, spam=None)
    kw = dict(cooc_layout=layout, region_chain=8) if layout == "region" \
        else {}
    slo = dict(slo_ms=1e9, up_lag=1e9, compact_min=16)
    j = JService(_jcfg("sweep", **kw), slo=joverload.SLOConfig(**slo))
    t = AssistanceService(_cfg("sweep", **kw), device=CPU,
                          slo=SLOConfig(**slo))
    _forced_run(j, _build(jworkload, 13, wcfg),
                JLogWriter(str(tmp_path / "jax"), ticks_per_segment=3))
    _forced_run(t, _build(workload, 13, wcfg),
                FirehoseLogWriter(str(tmp_path / "port"),
                                  ticks_per_segment=3))
    js, ts = j.overload.stats_snapshot(), t.overload.stats_snapshot()
    assert js.keys() == ts.keys()
    lat = {"step_p50_ms", "step_p95_ms", "step_p99_ms"}
    assert {k: v for k, v in ts.items() if k not in lat} == \
        {k: v for k, v in js.items() if k not in lat}
    assert ts["n_flushes"] < len(SCHEDULE) and ts["n_shed_events"] > 0
    # the controller steps its engines through step_many, which records no
    # maintenance stats (in JAX too): the free-region signal stays None
    assert t.overload._free_frac() is j.overload._free_frac() is None
    for part in (t, j):
        part.rt.last_maintenance = {"c_free_regions": 411.0}
    assert t.overload._free_frac() == j.overload._free_frac()
    assert (t.overload._free_frac() is None) == (layout == "hash")
    for part in ("rt", "bg"):
        je, te = getattr(j, part), getattr(t, part)
        assert compare_states(je.state_arrays(), te.state_arrays(),
                              te.cfg.decay.prune_threshold) == 0, part
        assert je.n_rank_cycles == te.n_rank_cycles
    got = list(FirehoseLogReader(str(tmp_path / "port")).read_ticks(0))
    exp = list(JLogReader(str(tmp_path / "jax")).read_ticks(0))
    assert [g[0] for g in got] == [e[0] for e in exp] == \
        list(range(len(SCHEDULE)))
    for (_, tev, ttw), (_, jev, jtw) in zip(got, exp):
        _arrays_equal(tev, jev)
        assert (ttw is None) == (jtw is None)
        if ttw is not None:
            _arrays_equal(ttw, jtw)


# ---------------------------------------------------------------------------
# The port against itself (tests/test_overload.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_shed_accounting_balances_at_every_level(level):
    """(offered) == (ingested) + (counted shed) at every ladder level, for
    the query hose, the tweet firehose, AND ranking cycles."""
    rng = np.random.default_rng(level)
    wl = _wl(seed=int(rng.integers(1 << 20)), spike_mult=6.0, spike_at=2)
    svc = AssistanceService(_cfg(), device=CPU, slo=_slo())
    svc.overload.ladder.force(level)
    n = 12
    for t in range(n):
        svc.step(*wl.gen_tick(t), lag_hint=float(rng.integers(0, 6)))
    svc.drain()
    c = svc.overload.counters
    assert int(svc.rt.state.tick) == n            # nothing lost in a buffer
    assert c["n_offered_events"] == c["n_ingested_events"] + c["n_shed_events"]
    assert c["n_offered_tweets"] == c["n_ingested_tweets"] + c["n_shed_tweets"]
    if level >= 3:
        assert c["n_shed_tweets"] == c["n_offered_tweets"] > 0
        assert c["n_shed_events"] > 0
    else:
        assert c["n_shed_events"] == 0 and c["n_shed_tweets"] == 0
    rt_dues = sum(rank_due(svc.rt.cfg, t) for t in range(n))
    bg_dues = sum(rank_due(svc.bg.cfg, t) for t in range(n))
    assert c["n_rank_run_rt"] + c["n_shed_rank_rt"] == rt_dues
    assert c["n_rank_run_bg"] + c["n_shed_rank_bg"] == bg_dues
    if level >= 1:
        assert c["n_rank_run_rt"] == 0
    snap = svc.overload.stats_snapshot()
    assert snap["n_shed_total"] == (c["n_shed_events"] + c["n_shed_tweets"]
                                    + c["n_shed_rank_rt"]
                                    + c["n_shed_rank_bg"])
    assert sum(snap["level_ticks"]) == n


def test_batched_service_matches_pertick_service():
    """Micro-batched flushes == per-tick stepping, bit for bit (lag
    pressure forces K up to batch_max mid-run); the flushed stacks, read
    by both engines, are left as they were."""
    wl = _wl(seed=7, spike_mult=4.0, spike_at=3)
    a = AssistanceService(_cfg(), device=CPU)
    b = AssistanceService(_cfg(), device=CPU,
                          slo=_slo(batch_max=8, lag_batch=0.5))
    stacks = []
    dispatch = b.overload._dispatch

    def keep(chunk, level):
        stacks.append((chunk, [x.copy() for x in chunk]))
        return dispatch(chunk, level)

    b.overload._dispatch = keep
    n = 14
    for t in range(n):
        ev, tw = wl.gen_tick(t)
        a.step(ev, tw)
        b.step(ev, tw, lag_hint=4.0 if t >= 4 else 0.0)
    b.drain()
    assert b.overload.counters["n_flushes"] < n         # batching happened
    assert max(c.n_ticks for c, _ in stacks) > 1
    for chunk, before in stacks:
        _arrays_equal(chunk, before)
    _bits_equal(a.rt.state_arrays(), b.rt.state_arrays())
    _bits_equal(a.bg.state_arrays(), b.bg.state_arrays())


def test_mirrors_equal_the_leader_after_a_spike():
    """Two follower rt engines fed the leader's flushed stacks through a
    spike, batching and every rung end bit for bit the leader, and none
    shares a tensor with it."""
    wl = _wl(seed=5, spike_mult=10.0, spike_at=2)
    cfg = _cfg()
    mirrors = [SearchAssistanceEngine(cfg, name=f"rt{i}", device=CPU)
               for i in (1, 2)]
    svc = AssistanceService(cfg, device=CPU, slo=_slo(lag_batch=0.5),
                            mirrors=mirrors)
    for t, level in enumerate(SCHEDULE):
        svc.overload.ladder.force(level)
        svc.step(*wl.gen_tick(t), lag_hint=float(LAGS[t]))
    svc.drain()
    assert svc.overload.counters["n_flushes"] < len(SCHEDULE)
    ptrs = lambda e: {e.state.qstore.key_hi.data_ptr(),
                      e.state.cooc.key_hi.data_ptr()}
    for m in mirrors:
        assert not ptrs(m) & ptrs(svc.rt)
        _bits_equal(m.state_arrays(), svc.rt.state_arrays())


def test_crash_recover_mid_shed_bitexact(tmp_path):
    """Crash INSIDE an actively-shedding window: restore + replay of the
    admitted log == the uninterrupted degraded run, bit for bit. This is
    the log-append-first + pure-hash-admission contract."""
    schedule = lambda t: 0 if t < 3 else (3 if t < 10 else 1)
    wl = _wl(seed=13, spike_mult=8.0, spike_at=3)
    n, crash_at, snap_at = 16, 10, 6

    def run(upto, svc=None, writer=None, ckpts=None):
        if svc is None:
            svc = AssistanceService(_cfg(), device=CPU, slo=_slo())
        start = int(svc.rt.state.tick)
        for t in range(start, upto):
            svc.overload.ladder.force(schedule(t))
            la = (lambda tk, e, w: writer.append(tk, e, w)) if writer else None
            svc.step(*wl.gen_tick(t), log_append=la,
                     lag_hint=3.0 if 4 <= t < 9 else 0.0)
            if t == snap_at - 1 and ckpts is not None:
                svc.drain()          # snapshot needs the engines caught up
                svc.save_snapshot(*ckpts)
        svc.drain()
        return svc

    a = run(n)
    log_dir = str(tmp_path / "log")
    ckpts = (CheckpointManager(str(tmp_path / "rt"), full_interval=3),
             CheckpointManager(str(tmp_path / "bg"), full_interval=3))
    w = FirehoseLogWriter(log_dir, ticks_per_segment=2)
    run(crash_at, writer=w, ckpts=ckpts)
    w.close()   # 10 appended ticks seal cleanly; the process "dies" here
    assert ckpts[0].manifest()["meta"]["overload"]["level"] == 3

    rec, rstats = recover_service(_cfg(), ckpts[0], ckpts[1], log_dir,
                                  ReplayConfig(chunk_ticks=4), device=CPU)
    assert rstats["rt"]["restored_step"] == snap_at
    assert rstats["rt"]["n_ticks"] == crash_at - snap_at   # replayed tail
    b = AssistanceService(rt=rec.rt, bg=rec.bg, slo=_slo())
    w2 = FirehoseLogWriter(log_dir, ticks_per_segment=2)
    b = run(n, svc=b, writer=w2)
    w2.close()
    _bits_equal(a.rt.state_arrays(), b.rt.state_arrays())
    _bits_equal(a.bg.state_arrays(), b.bg.state_arrays())
    # the log recorded the ADMITTED stream: level-3 ticks carry no tweets
    logged = {t: (ev, tw) for t, ev, tw in
              FirehoseLogReader(log_dir).read_ticks(0)}
    assert logged[5][1] is None and logged[12][1] is not None


def test_chaos_slow_io_torn_writer_spike(tmp_path, monkeypatch):
    """Flash-crowd traffic + a slowed disk + a writer killed mid-segment:
    the slow seals sleep (recorded, not timed), recovery truncates the torn
    tail and the accounting invariant holds throughout."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    wl = _wl(seed=5, spike_mult=10.0, spike_at=2)
    log_dir = str(tmp_path / "log")
    w = FirehoseLogWriter(log_dir, ticks_per_segment=4)
    slow_io(w, ("flush",), 0.01)
    svc = AssistanceService(_cfg(), device=CPU,
                            slo=_slo(up_lag=2.0, up_ticks=2, down_ticks=3))
    la = lambda t, e, tw: w.append(t, e, tw)
    for t in range(7):
        svc.step(*wl.gen_tick(t), log_append=la, lag_hint=3.0)
    torn = kill_writer_mid_segment(w)         # dies with a partial buffer
    assert torn is not None
    svc.drain()
    assert slept and all(s == 0.01 for s in slept)
    assert svc.overload.ladder.n_escalations > 0
    c = svc.overload.counters
    assert c["n_offered_events"] == c["n_ingested_events"] + c["n_shed_events"]
    assert c["n_offered_tweets"] == c["n_ingested_tweets"] + c["n_shed_tweets"]
    r = FirehoseLogReader(log_dir)
    assert r.last_tick() is not None and r.last_tick() < 6
    assert r.n_unmanifested_files == 1
    r.repair()
    assert FirehoseLogReader(log_dir).n_unmanifested_files == 0


def test_frontend_overload_metrics(tmp_path):
    wl = _wl(seed=8, spike_mult=0.0, spam=None)
    svc = AssistanceService(_cfg(), device=CPU, slo=_slo())
    svc.overload.ladder.force(3)
    for t in range(6):
        svc.step(*wl.gen_tick(t))
    svc.drain()
    rt_dir = str(tmp_path / "rt")
    svc.rt.run_rank_cycle()
    CheckpointManager(rt_dir).save(
        5, pack_suggestions(svc.rt.suggestions),
        meta={"tick": 5, "overload": svc.overload.stats_snapshot()})
    f = SuggestFrontend(rt_dir)
    f.poll()
    m = f.metrics()
    assert m["shed_level"] == 3 and m["shed_level_name"] == "sample_ingest"
    assert m["n_shed_events"] > 0 and m["n_shed_total"] > 0
    assert m["n_shed_rank"] == (svc.overload.counters["n_shed_rank_rt"]
                                + svc.overload.counters["n_shed_rank_bg"])
    assert m["step_p95_ms"] is not None and m["step_p95_ms"] > 0
    assert m["overload"] == svc.overload.stats_snapshot()
    plain_dir = str(tmp_path / "plain")
    CheckpointManager(plain_dir).save(
        1, pack_suggestions(svc.rt.suggestions), meta={"tick": 1})
    f2 = SuggestFrontend(plain_dir)
    f2.poll()
    m2 = f2.metrics()
    assert m2["shed_level"] is None and m2["overload"] is None
    assert m2["step_p95_ms"] is None and m2["n_shed_rank"] is None


def test_legacy_service_path_unchanged(tmp_path):
    """Without ``slo`` the service still steps per tick; ``log_append``
    fires before ingestion and ``drain`` is a no-op."""
    wl = _wl(seed=6, spike_mult=0.0, spam=None)
    svc = AssistanceService(_cfg(), device=CPU)
    assert svc.overload is None
    w = FirehoseLogWriter(str(tmp_path), ticks_per_segment=2)
    seen = []
    for t in range(4):
        ev, tw = wl.gen_tick(t)
        svc.step(ev, tw, log_append=lambda tk, e, x: (seen.append(tk),
                                                      w.append(tk, e, x)))
    assert seen == [0, 1, 2, 3]
    assert svc.drain() is None
    assert int(svc.rt.state.tick) == 4

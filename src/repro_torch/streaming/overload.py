"""Overload control for the live serving path (§1, §4: survive the spike).

The paper's motivating workload is the breaking-news flash crowd: query
volume spikes 10-100x within minutes, and the backend must stay fresh *and*
stay up. Crash recovery (``streaming.replay``) makes the stack restartable;
this module makes it overload-tolerant, with the two defining fast-data
mechanisms (Kejariwal et al. 1708.02621, §load shedding; 1403.3375
§admission control):

**Adaptive micro-batching** (:class:`AdaptiveMicroBatcher` inside
:class:`OverloadController`): when lag builds, live ticks are buffered and
dispatched as ONE ``engine.step_many`` flush — the catch-up replay
primitive reused live. The batch size K adapts to lag, quantized to powers
of two up to ``batch_max``. At zero lag K=1 and the path degenerates to
per-tick dispatch (minimum latency).

**Degradation ladder** (:class:`DegradationLadder`) — shed the cheapest
freshness first, never correctness, and never silently:

  ====  =============  ====================================================
  lvl   name           behavior added at this level
  ====  =============  ====================================================
  0     normal         full service
  1     shed_rank      rt ranking cycles shed (frontends serve the last
                       persisted tables — the §4.2 staleness stance)
  2     stretch_bg     bg ranking cadence stretched ``bg_stretch``x
                       (1 in N due cycles runs)
  3     sample_ingest  tweet-firehose ingest shed entirely; tail-source
                       query events (``src >= tail_src``, the low §4.2
                       source weights) hash-sampled down to ``tail_keep``
  ====  =============  ====================================================

Triggers (any): effective lag >= ``up_lag`` ticks; step-latency p95 over
``slo_ms``; region-freelist pressure under ``freelist_min``. Hysteresis:
a level moves only after ``up_ticks`` consecutive hot observations (up) or
``down_ticks`` consecutive cool ones (down), one rung at a time, so the
ladder cannot flap. Every shed decision is counted (``stats_snapshot``),
never silent.

**Bit-exact shedding** — the crash-recovery contract survives every level:
admission runs BEFORE the durable log append, so the log records exactly
the admitted stream; sampling is a pure hash of the event fingerprints
(:func:`admit_events` — no RNG, no clock), so the same events are admitted
no matter when the process restarts; maintenance cadences are never
touched (only read-only ranking is shed). Replaying the log therefore
reproduces the degraded run bit for bit, mid-shed crash included.

Port of the JAX package's ``streaming/overload.py``. Ladder, admission and
batching are host numpy, bit-identical to JAX's; a flush moves the stacked
ticks to the service's device once (``chunk_to_stack``) and every engine
steps them there, so on CUDA the ingest kernels run on the card. A flush's
step latency includes the device's work: each ``step_many`` ends by
reading the engine's tick back to the host.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.engine import rank_due
from ..data.stream import QueryEvents, TweetBatch, _mix64
from .log import LogChunk, _LANES, _record_arrays
from .replay import chunk_to_stack
from .workload import bucket_size

LEVEL_NAMES = ("normal", "shed_rank", "stretch_bg", "sample_ingest")

# fixed salt: admission must be a pure function of the event fingerprints
_SHED_SALT = np.uint64(0x5EDD1C7A7E5EED11)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Knobs of the overload-control layer (all cadences in ticks)."""
    slo_ms: float = 50.0         # step-latency target (p95 per tick)
    latency_window: int = 256    # latency samples kept for percentiles
    # micro-batcher
    batch_max: int = 8           # max ticks fused into one dispatch
    lag_batch: float = 1.5       # batching starts past this lag
    # ladder triggers + hysteresis
    up_lag: float = 4.0          # hot when effective lag >= this
    down_lag: float = 1.0        # cool when effective lag <= this
    up_ticks: int = 3            # consecutive hot ticks to go up a rung
    down_ticks: int = 6          # consecutive cool ticks to come down
    freelist_min: float = 0.05   # hot when free-region fraction below
    # level-2: bg ranking cadence stretch (1 in N due cycles runs)
    bg_stretch: int = 4
    # level-3 admission control
    tail_src: int = 2            # sources >= this are tail (§4.2 hashtag
                                 # click); 0 = sample the whole hose
    tail_keep: float = 0.25      # keep fraction of tail-source events
    compact_min: int = 64        # smallest compacted event bucket


class LatencyTracker:
    """Sliding-window step-latency percentiles (host wall clock, ms)."""

    def __init__(self, window: int = 256):
        self._buf: deque = deque(maxlen=window)

    def record(self, ms: float, n: int = 1) -> None:
        """Record ``n`` ticks that each cost ``ms`` (a fused flush of n
        ticks attributes the amortized per-tick latency to every tick)."""
        self._buf.extend([float(ms)] * int(n))

    def percentile(self, p: float) -> Optional[float]:
        if not self._buf:
            return None
        return float(np.percentile(np.fromiter(self._buf, float), p))

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {"p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "n_samples": len(self._buf)}


class DegradationLadder:
    """Hysteretic 4-level ladder (see module docstring for the rungs).

    ``observe()`` once per offered tick moves at most one rung after the
    configured number of consecutive confirmations. ``force(level)`` pins
    the level (chaos/property tests script deterministic shed schedules
    with it); ``force(None)`` unpins.
    """

    def __init__(self, cfg: SLOConfig):
        self.cfg = cfg
        self.level = 0
        self.n_escalations = 0
        self.n_deescalations = 0
        self.level_ticks = [0, 0, 0, 0]
        self._hot = 0
        self._cool = 0
        self._forced: Optional[int] = None

    @property
    def name(self) -> str:
        return LEVEL_NAMES[self.level]

    def force(self, level: Optional[int]) -> None:
        if level is not None:
            assert 0 <= level < len(LEVEL_NAMES)
            self.level = level
        self._forced = level

    def observe(self, *, lag: float, p95_ms: Optional[float] = None,
                free_frac: Optional[float] = None) -> int:
        if self._forced is not None:
            self.level = self._forced
            self.level_ticks[self.level] += 1
            return self.level
        cfg = self.cfg
        hot = (lag >= cfg.up_lag
               or (p95_ms is not None and p95_ms > cfg.slo_ms)
               or (free_frac is not None and free_frac < cfg.freelist_min))
        cool = (lag <= cfg.down_lag
                and (p95_ms is None or p95_ms <= 0.8 * cfg.slo_ms)
                and (free_frac is None
                     or free_frac >= min(1.0, 2.0 * cfg.freelist_min)))
        if hot:
            self._hot += 1
            self._cool = 0
        elif cool:
            self._cool += 1
            self._hot = 0
        else:
            self._hot = self._cool = 0
        if self._hot >= cfg.up_ticks and self.level < 3:
            self.level += 1
            self.n_escalations += 1
            self._hot = 0
        elif self._cool >= cfg.down_ticks and self.level > 0:
            self.level -= 1
            self.n_deescalations += 1
            self._cool = 0
        self.level_ticks[self.level] += 1
        return self.level


# ---------------------------------------------------------------------------
# Admission control (level 3) — deterministic, pre-log, physically compacting
# ---------------------------------------------------------------------------

def admit_events(ev: Optional[QueryEvents], level: int, cfg: SLOConfig
                 ) -> Tuple[Optional[QueryEvents], int]:
    """Admission-control one tick's query events at ``level``.

    Below level 3 this is the identity. At level 3, tail-source events
    (``src >= cfg.tail_src`` — source ids order head to tail, so lowering
    ``tail_src`` widens the sampled band, ``tail_src=0`` samples the whole
    hose) are kept with probability ``cfg.tail_keep`` by a
    pure hash of ``q_fp ^ sess_fp`` (splitmix64 vs a fixed threshold): the
    SAME events are shed on every run — which is what keeps replay of the
    admitted log bit-exact. Survivors are physically compacted into the
    smallest power-of-4 bucket >= ``cfg.compact_min`` (order preserved),
    so shedding reduces device work, not just the valid mask.

    Returns ``(admitted_events, n_shed)``.
    """
    if ev is None:
        return None, 0
    valid = np.asarray(ev.valid, bool)
    if level < 3:
        return ev, 0
    keep = valid.copy()
    tail = valid & (np.asarray(ev.src) >= cfg.tail_src)
    if tail.any():
        h = _mix64(np.asarray(ev.q_fp, np.uint64)
                   ^ np.asarray(ev.sess_fp, np.uint64) ^ _SHED_SALT)
        thr = np.uint64(int(cfg.tail_keep * float(np.iinfo(np.uint64).max)))
        keep &= ~tail | (h < thr)
    n_shed = int(valid.sum()) - int(keep.sum())
    if n_shed == 0:
        return ev, 0
    idx = np.nonzero(keep)[0]
    B = bucket_size(len(idx), cfg.compact_min, valid.shape[0])
    out = QueryEvents(
        sess_fp=_take(np.asarray(ev.sess_fp, np.uint64), idx, B),
        q_fp=_take(np.asarray(ev.q_fp, np.uint64), idx, B),
        src=_take(np.asarray(ev.src, np.int32), idx, B),
        valid=_valid_mask(len(idx), B))
    return out, n_shed


def admit_tweets(tw: Optional[TweetBatch], level: int, cfg: SLOConfig
                 ) -> Tuple[Optional[TweetBatch], int]:
    """Level 3 sheds the tweet firehose entirely (the T*G*G pair blowup is
    the most expensive per-tick work and the lowest-weight signal,
    ``tweet_weight``); below level 3, identity. Returns ``(tw, n_shed)``."""
    if tw is None or level < 3:
        return tw, 0
    return None, int(np.asarray(tw.valid, bool).sum())


def _take(a: np.ndarray, idx: np.ndarray, size: int) -> np.ndarray:
    out = np.zeros((size,) + a.shape[1:], a.dtype)
    out[: len(idx)] = a[idx]
    return out


def _valid_mask(n: int, size: int) -> np.ndarray:
    v = np.zeros(size, bool)
    v[:n] = True
    return v


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

class AdaptiveMicroBatcher:
    """Buffers admitted ticks; flushes stackable runs of K ticks.

    K follows lag, quantized to powers of two capped at ``batch_max``. A
    shape change flushes first (a stack must be stackable — same rule as
    the log's segment rotation and the reader's chunk merging).
    """

    def __init__(self, cfg: SLOConfig):
        self.cfg = cfg
        self._buf: List[Dict[str, np.ndarray]] = []
        self._ticks: List[int] = []

    def __len__(self) -> int:
        return len(self._buf)

    def k_target(self, lag: float) -> int:
        if lag <= self.cfg.lag_batch:
            return 1
        k = 1
        while k < self.cfg.batch_max and k < lag:
            k *= 2
        return min(k, self.cfg.batch_max)

    def add(self, tick: int, ev: Optional[QueryEvents],
            tw: Optional[TweetBatch]) -> Optional[LogChunk]:
        """Buffer one admitted tick; returns a chunk to dispatch when the
        new tick's shapes are incompatible with the buffered run."""
        rec = _record_arrays(tick, ev, tw)
        out = None
        if self._buf and any(rec[k].shape != self._buf[-1][k].shape
                             for k in _LANES[1:]):
            out = self.take()
        self._buf.append(rec)
        self._ticks.append(int(tick))
        return out

    def take(self) -> Optional[LogChunk]:
        """Pop the buffered run as one stacked chunk (None if empty)."""
        if not self._buf:
            return None
        chunk = LogChunk(**{k: np.stack([r[k] for r in self._buf])
                            for k in _LANES})
        self._buf, self._ticks = [], []
        return chunk


class OverloadController:
    """SLO-driven live ingestion for one :class:`AssistanceService`.

    ``offer(events, tweets)`` replaces per-tick ``service.step``: it runs
    the ladder, admission-controls the tick, appends the ADMITTED batch to
    the durable log (``log_append`` callback — ordered before ingestion so
    the log is always a superset of engine state), buffers it, and
    dispatches ``ingest_many`` flushes when the adaptive batch size is
    reached. Ranking is governed here (shed/stretched per the ladder;
    ranking reads state but never mutates it, so this cannot perturb the
    replay-equality contract). ``mirrors`` are extra follower rt engines
    (replica failover targets) fed the same flushed stacks: one stack on
    the service's device, which every engine only reads. The stores write
    their own tensors in place, so each mirror must hold its own state
    (``engine.clone_state``), never the leader's.

    Accounting invariant (property-tested): at every level, after
    ``drain()``, offered events == ingested events + counted-shed events,
    for the query hose and the tweet firehose separately.
    """

    def __init__(self, service, cfg: SLOConfig,
                 mirrors: Sequence = ()):
        self.svc = service
        self.cfg = cfg
        self.ladder = DegradationLadder(cfg)
        self.latency = LatencyTracker(cfg.latency_window)
        self.batcher = AdaptiveMicroBatcher(cfg)
        self.mirrors = list(mirrors)
        self.counters: Dict[str, int] = {
            "n_offered_events": 0, "n_ingested_events": 0,
            "n_shed_events": 0,
            "n_offered_tweets": 0, "n_ingested_tweets": 0,
            "n_shed_tweets": 0,
            "n_rank_run_rt": 0, "n_shed_rank_rt": 0,
            "n_rank_run_bg": 0, "n_shed_rank_bg": 0,
            "n_flushes": 0, "n_flush_ticks": 0,
        }
        self._bg_due_seen = 0
        self.last_flush: Dict = {}

    # -- signals --
    def _free_frac(self) -> Optional[float]:
        eng = self.svc.rt
        if not eng.cfg.region_cooc:
            return None
        fr = eng.last_maintenance.get("c_free_regions")
        if fr is None:
            return None
        total = max(eng.cfg.cooc_capacity // eng.cfg.region_w, 1)
        return float(fr) / total

    # -- the live path --
    def offer(self, events: Optional[QueryEvents] = None,
              tweets: Optional[TweetBatch] = None, *,
              log_append: Optional[Callable] = None,
              lag_hint: float = 0.0) -> Optional[Dict]:
        """Process one offered tick; returns rank stats iff a flush ranked."""
        backlog = len(self.batcher)
        tick = int(self.svc.rt.state.tick) + backlog
        lag = backlog + max(float(lag_hint), 0.0)
        level = self.ladder.observe(lag=lag,
                                    p95_ms=self.latency.percentile(95),
                                    free_frac=self._free_frac())

        if events is not None:
            self.counters["n_offered_events"] += \
                int(np.asarray(events.valid, bool).sum())
        if tweets is not None:
            self.counters["n_offered_tweets"] += \
                int(np.asarray(tweets.valid, bool).sum())
        ev, shed_q = admit_events(events, level, self.cfg)
        tw, shed_t = admit_tweets(tweets, level, self.cfg)
        self.counters["n_shed_events"] += shed_q
        self.counters["n_shed_tweets"] += shed_t

        # log-append FIRST (durability precedes ingestion): the log records
        # exactly the admitted stream, so crash recovery mid-shed replays
        # the degraded run bit for bit.
        if log_append is not None:
            log_append(tick, ev, tw)

        out = None
        rotated = self.batcher.add(tick, ev, tw)
        if rotated is not None:                 # shape change forced it out
            out = self._dispatch(rotated, level)
        if len(self.batcher) >= self.batcher.k_target(lag):
            r = self._dispatch(self.batcher.take(), level)
            out = r if out is None else out
        return out

    def drain(self) -> Optional[Dict]:
        """Flush whatever is buffered (shutdown / end of stream)."""
        chunk = self.batcher.take()
        if chunk is None:
            return None
        return self._dispatch(chunk, self.ladder.level)

    # -- flush --
    def _dispatch(self, chunk: LogChunk, level: int) -> Optional[Dict]:
        t0 = time.perf_counter()
        stack = chunk_to_stack(chunk, self.svc.rt.device)
        self.svc.rt.step_many(stack)
        self.svc.bg.step_many(stack)
        for m in self.mirrors:
            m.step_many(stack)
        n = chunk.n_ticks
        lo, hi = int(chunk.ticks[0]), int(chunk.ticks[-1]) + 1
        rank = self._govern_ranking(lo, hi, level)
        ms = (time.perf_counter() - t0) * 1e3 / n
        self.latency.record(ms, n)
        self.counters["n_flushes"] += 1
        self.counters["n_flush_ticks"] += n
        self.counters["n_ingested_events"] += int(chunk.q_valid.sum())
        self.counters["n_ingested_tweets"] += int(chunk.t_valid.sum())
        self.last_flush = {"n_ticks": n, "ms_per_tick": ms, "level": level}
        return rank

    def _govern_ranking(self, lo: int, hi: int, level: int
                        ) -> Optional[Dict]:
        """Run/shed the rank cycles due in [lo, hi) per the ladder.

        Batching runs at most one cycle per engine per flush (the catch-up
        controller's run-one pattern — extra dues in a fused flush are
        counted shed); level >= 1 sheds rt cycles outright; level >= 2
        runs only 1 in ``bg_stretch`` bg dues. Counted, never silent.
        """
        c = self.counters
        rt_due = [t for t in range(lo, hi)
                  if rank_due(self.svc.rt.cfg, t)]
        bg_due = [t for t in range(lo, hi)
                  if rank_due(self.svc.bg.cfg, t)]
        r1 = r2 = None
        if rt_due:
            if level >= 1:
                c["n_shed_rank_rt"] += len(rt_due)
            else:
                r1 = self.svc.rt.run_rank_cycle()
                c["n_rank_run_rt"] += 1
                c["n_shed_rank_rt"] += len(rt_due) - 1
        run_bg = 0
        for _ in bg_due:
            if level >= 2:
                if self._bg_due_seen % self.cfg.bg_stretch == 0:
                    run_bg = 1
                self._bg_due_seen += 1
            else:
                self._bg_due_seen += 1
                run_bg = 1
        if bg_due:
            if run_bg:
                r2 = self.svc.bg.run_rank_cycle()
                c["n_rank_run_bg"] += 1
            c["n_shed_rank_bg"] += len(bg_due) - run_bg
        if r1 is not None or r2 is not None:
            self.svc.refresh_cache()
            return {"rt": r1, "bg": r2}
        return None

    # -- observability --
    def stats_snapshot(self) -> Dict:
        """JSON-serializable overload state — rides into snapshot meta and
        out through ``SuggestFrontend.metrics()``. Every shed path above
        has a counter here: nothing is shed silently."""
        out: Dict = dict(self.counters)
        out["level"] = self.ladder.level
        out["level_name"] = self.ladder.name
        out["level_ticks"] = list(self.ladder.level_ticks)
        out["n_escalations"] = self.ladder.n_escalations
        out["n_deescalations"] = self.ladder.n_deescalations
        out["n_shed_total"] = (out["n_shed_events"] + out["n_shed_tweets"]
                               + out["n_shed_rank_rt"]
                               + out["n_shed_rank_bg"])
        out["slo_ms"] = self.cfg.slo_ms
        out.update({f"step_{k}_ms": v for k, v in
                    self.latency.snapshot().items() if k != "n_samples"})
        out["backlog_ticks"] = len(self.batcher)
        return out

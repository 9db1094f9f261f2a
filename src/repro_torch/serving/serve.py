"""Serving frontend (paper §4.2, Figure 4).

Port of the JAX package's ``serving/serve.py``: host-only numpy code. A
frontend reads persisted checkpoints and never touches a device. The
on-disk formats are the JAX package's, so each package's frontend serves
the other's directories. ``ServerSet`` is ported whole (timeouts,
retries with backoff, hedging, the circuit breaker): that routing policy
is the paper's ServerSet.

"Lightweight in-memory caches, which periodically read fresh results from
HDFS, serve as the frontend nodes ... together they form a single
replicated, fault-tolerant service endpoint that can be arbitrarily scaled
out." Request routing in the paper goes through the ServerSet abstraction
(client-side load balancing over live replicas via ZooKeeper).

Here: ``SuggestFrontend`` polls a checkpoint directory for the newest
persisted suggestion tables (real-time + background), interpolates them at
serve time (§4.5), and resolves fingerprints back to strings through the
tokenizer. ``ServerSet`` is the client-side balancer over frontend replicas
with liveness-based failover, staleness-aware ordering (freshest tables
first), bounded retry-with-backoff, hedged second requests, and per-replica
circuit breakers; every response is tagged with the serving replica's tick
and staleness (:class:`RouteResult`).

Staleness (§4.2): during a backend crash + catch-up replay the frontends
keep serving "the most recently persisted results" — deliberately stale.
``SuggestFrontend.metrics()`` quantifies that: the age of the loaded
tables and, when pointed at the durable firehose log, the tick lag between
what the tables reflect and the log head (``catching_up`` flips true while
a restarted backend is still replaying).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.background import interpolate
from ..core.hashing import fingerprint
from ..core.plan import TunedPlan
from ..data.tokenizer import NGramTokenizer
from ..distributed.fault_tolerance import CheckpointManager
from ..streaming.log import FirehoseLogReader

# an engine whose tables lag the log head by more ticks than this is
# reported as catching up (``metrics()``)
STALE_LAG_TICKS = 4


def pack_suggestions(sugg: Dict[int, List[Tuple[int, float]]]) -> Dict[str, np.ndarray]:
    """Suggestion dict -> flat arrays for checkpointing."""
    srcs, dsts, scores, offs = [], [], [], [0]
    for s, lst in sugg.items():
        srcs.append(s)
        for d, sc in lst:
            dsts.append(d)
            scores.append(sc)
        offs.append(len(dsts))
    return {"src": np.asarray(srcs, np.uint64),
            "dst": np.asarray(dsts, np.uint64),
            "score": np.asarray(scores, np.float64),
            "offsets": np.asarray(offs, np.int64)}


def unpack_suggestions(arrays) -> Dict[int, List[Tuple[int, float]]]:
    out: Dict[int, List[Tuple[int, float]]] = {}
    src = arrays["src"]
    offs = arrays["offsets"]
    for i, s in enumerate(src):
        lo, hi = int(offs[i]), int(offs[i + 1])
        out[int(s)] = [(int(d), float(sc))
                       for d, sc in zip(arrays["dst"][lo:hi],
                                        arrays["score"][lo:hi])]
    return out


class SuggestFrontend:
    """One frontend cache replica: polls persisted results, serves lookups."""

    def __init__(self, rt_dir: str, bg_dir: Optional[str] = None,
                 tok: Optional[NGramTokenizer] = None,
                 spell_dir: Optional[str] = None,
                 log_dir: Optional[str] = None):
        self.rt_ckpt = CheckpointManager(rt_dir)
        self.bg_ckpt = CheckpointManager(bg_dir) if bg_dir else None
        self.spell_ckpt = CheckpointManager(spell_dir) if spell_dir else None
        self.tok = tok or NGramTokenizer()
        self._rt: Dict = {}
        self._bg: Dict = {}
        self._spell: Dict[int, Tuple[int, float]] = {}
        self._cache: Dict = {}
        self._loaded_steps = (None, None, None)
        self._rt_manifest: Dict = {}
        self._bg_manifest: Dict = {}
        self.stale_lag_ticks = STALE_LAG_TICKS
        self._log_reader = None
        if log_dir is not None:
            # verify=False: metrics only needs the manifest tail tick —
            # checksumming every segment on each poll would be O(log bytes)
            self._log_reader = FirehoseLogReader(log_dir, verify=False)
        self.alive = True

    def poll(self) -> bool:
        """Load newer persisted results if any (the paper's 1-min poll)."""
        steps = (self.rt_ckpt.latest_step(),
                 self.bg_ckpt.latest_step() if self.bg_ckpt else None,
                 self.spell_ckpt.latest_step() if self.spell_ckpt else None)
        if steps == self._loaded_steps:
            return False
        if steps[0] is not None:
            self._rt = self._load(self.rt_ckpt, steps[0])
            self._rt_manifest = self.rt_ckpt.manifest(steps[0])
        if self.bg_ckpt and steps[1] is not None:
            self._bg = self._load(self.bg_ckpt, steps[1])
            self._bg_manifest = self.bg_ckpt.manifest(steps[1])
        if self.spell_ckpt and steps[2] is not None:
            arrs, _, _ = self.spell_ckpt.load_arrays(steps[2])
            self._spell = {int(a): (int(b), float(d)) for a, b, d in
                           zip(arrs["leaf_0"], arrs["leaf_1"], arrs["leaf_2"])}
        self._cache = interpolate(self._rt, self._bg)
        self._loaded_steps = steps
        return True

    @staticmethod
    def _load(ckpt: CheckpointManager, step: int) -> Dict:
        arrs, _, _ = ckpt.load_arrays(step)
        # saved via pack_suggestions tree order: dst, offsets, score, src
        named = dict(zip(["dst", "offsets", "score", "src"],
                         [arrs[f"leaf_{i}"] for i in range(4)]))
        return unpack_suggestions(named)

    # ---- staleness / lag (§4.2: stale-but-available during catch-up) ----
    @staticmethod
    def _next_tick(meta: Dict) -> Optional[int]:
        # two producer conventions: engine snapshots (``save_snapshot``)
        # record ``log_tick`` = the NEXT tick to replay (tables reflect
        # log_tick - 1); suggestion-table persists (serve_assist) record
        # ``tick`` = the LAST tick reflected.
        if "log_tick" in meta:
            return int(meta["log_tick"])
        if "tick" in meta:
            return int(meta["tick"]) + 1
        return None

    def metrics(self, now: Optional[float] = None) -> Dict:
        """How stale is what this frontend serves — for BOTH halves.

        ``rt_age_s``/``bg_age_s``: wall-clock age of the loaded real-time /
        background tables. ``rt_tick``/``bg_tick``: the engine tick each
        half's tables reflect (from its checkpoint manifest's
        ``log_tick``/``tick`` meta). ``log_head_tick`` and the per-engine
        ``rt_lag_ticks``/``bg_lag_ticks``: with a firehose-log reader
        attached, how far behind the durable log head each half's served
        tables are; ``rt_catching_up``/``bg_catching_up`` flip true while
        that engine's lag exceeds ``stale_lag_ticks`` — i.e. that half of a
        restarted backend is still replaying and this frontend knowingly
        serves its stale suggestions. During whole-stack recovery the two
        halves catch up independently (the bg engine typically snapshots
        less often and replays a longer tail), which is why operators need
        both. ``lag_ticks``/``catching_up`` remain the rt aliases.

        Overload state (when the backend runs under the JAX package's
        ``streaming.overload.OverloadController`` — its stats ride in the
        snapshot meta; the port has no overload control yet): ``step_p50_ms``/``step_p95_ms``/``step_p99_ms``
        per-tick step-latency percentiles, ``shed_level`` /
        ``shed_level_name`` the degradation-ladder rung the backend was on,
        ``n_shed_events``/``n_shed_rank``/``n_shed_total`` the shed
        counters (nothing is shed silently), and the full raw counter dict
        under ``overload``. All ``None`` for a backend without overload
        control.
        """
        now = time.time() if now is None else now
        meta = self._rt_manifest.get("meta", {})
        bg_meta = self._bg_manifest.get("meta", {})
        rt_next = self._next_tick(meta)
        bg_next = self._next_tick(bg_meta)
        out: Dict = {
            "rt_step": self._loaded_steps[0],
            "rt_age_s": (now - self._rt_manifest["time"]
                         if "time" in self._rt_manifest else None),
            "rt_tick": None if rt_next is None else rt_next - 1,
            "bg_step": self._loaded_steps[1],
            "bg_age_s": (now - self._bg_manifest["time"]
                         if "time" in self._bg_manifest else None),
            "bg_tick": None if bg_next is None else bg_next - 1,
            "log_head_tick": None,
            "log_floor_tick": None,
            "log_first_tick": None,
            "n_log_bases": 0,
            "lag_ticks": None,
            "rt_lag_ticks": None,
            "bg_lag_ticks": None,
            "catching_up": False,
            "rt_catching_up": False,
            "bg_catching_up": False,
            # backend store health from the snapshot meta: the engine's
            # last maintenance-cycle stats (live/reclaimed slot counts and,
            # under the region cooc layout, freelist pressure as
            # ``c_free_regions``) plus the layout that produced them.
            "store_layout": meta.get("layout"),
            "store": meta.get("maintenance"),
        }
        # the backend's tuned plan (``launch/autotune``): which variant each
        # hot path runs and the tuning knobs; None for an untuned backend.
        plan = meta.get("plan")
        out["tuned_plan"] = plan
        out["tuned_variants"] = None
        if plan:
            try:
                out["tuned_variants"] = TunedPlan.from_json(plan).variants()
            except (TypeError, ValueError):
                pass                        # unknown future plan schema
        # backend overload state (streaming.overload): the controller's
        # stats ride in the snapshot meta. Surface the SLO-facing subset
        # flat (step-latency percentiles, degradation level, shed
        # counters) and the full counter dict raw under ``overload``.
        ov = meta.get("overload")
        out["overload"] = ov
        ov = ov or {}
        out["step_p50_ms"] = ov.get("step_p50_ms")
        out["step_p95_ms"] = ov.get("step_p95_ms")
        out["step_p99_ms"] = ov.get("step_p99_ms")
        out["shed_level"] = ov.get("level")
        out["shed_level_name"] = ov.get("level_name")
        out["n_shed_events"] = ov.get("n_shed_events")
        out["n_shed_rank"] = (
            None if ov.get("n_shed_rank_rt") is None
            else ov["n_shed_rank_rt"] + ov.get("n_shed_rank_bg", 0))
        out["n_shed_total"] = ov.get("n_shed_total")
        if self._log_reader is not None:
            self._log_reader.refresh()
            head = self._log_reader.last_tick()
            out["log_head_tick"] = head
            # compacted storage tier: the replay floor (newest advertised
            # base) and how far back the on-disk tail actually reaches —
            # "can this frontend's backend still rebuild from zero, and
            # from where" at a glance.
            out["log_floor_tick"] = self._log_reader.floor_tick()
            out["log_first_tick"] = self._log_reader.first_tick()
            out["n_log_bases"] = len(self._log_reader.bases)
            if head is not None:
                # pending = logged ticks the served tables don't reflect
                out["rt_lag_ticks"] = max(
                    0, head + 1 - (rt_next if rt_next is not None else 0))
                out["rt_catching_up"] = \
                    out["rt_lag_ticks"] > self.stale_lag_ticks
                out["lag_ticks"] = out["rt_lag_ticks"]
                out["catching_up"] = out["rt_catching_up"]
                if self.bg_ckpt is not None:
                    out["bg_lag_ticks"] = max(
                        0, head + 1 - (bg_next if bg_next is not None else 0))
                    out["bg_catching_up"] = \
                        out["bg_lag_ticks"] > self.stale_lag_ticks
        return out

    # ---- request path ----
    def freshness_tick(self) -> Optional[int]:
        """The engine tick this frontend's served tables reflect (the
        router's staleness key — no disk I/O, reads the loaded manifest)."""
        nxt = self._next_tick(self._rt_manifest.get("meta", {}))
        return None if nxt is None else nxt - 1

    def related(self, query: str, k: int = 8) -> List[Tuple[str, float]]:
        fp = fingerprint(" ".join(query.lower().split()))
        return [(self.tok.text(d), s) for d, s in self._cache.get(fp, [])[:k]]

    def spelling(self, query: str) -> Optional[str]:
        fp = fingerprint(" ".join(query.lower().split()))
        hit = self._spell.get(fp)
        return self.tok.text(hit[0]) if hit else None


@dataclasses.dataclass(frozen=True)
class RouteResult:
    """One answered request, tagged so degraded answers are honest."""
    suggestions: List[Tuple[str, float]]
    replica: int                 # index of the replica that answered
    tick: Optional[int]          # freshness tick of that replica's tables
    staleness: Optional[int]     # ticks behind the freshest live replica
    hedged: bool                 # answered by a hedge, not the primary
    attempts: int                # replicas tried (1 = primary answered)


class _Breaker:
    """Per-replica circuit breaker on a deterministic request-count clock:
    ``threshold`` consecutive failures open the circuit for ``cooldown``
    subsequent requests, after which one half-open probe is allowed."""

    def __init__(self, threshold: int, cooldown: int):
        self.threshold = threshold
        self.cooldown = cooldown
        self.failures = 0
        self.open_until = -1

    def allow(self, now: int) -> bool:
        return self.failures < self.threshold or now >= self.open_until

    def record(self, ok: bool, now: int) -> None:
        if ok:
            self.failures = 0
            return
        self.failures += 1
        if self.failures >= self.threshold:
            self.open_until = now + self.cooldown


class ServerSet:
    """Client-side load-balanced access to replicated frontends with
    failover (the paper's ZooKeeper-coordinated ServerSet, simulated).

    Routing is health- and staleness-aware: live replicas are tried
    freshest-first (``freshness_tick()``, missing = oldest; ties rotate
    round-robin so equally-fresh replicas share load). A replica that is
    marked dead, raises, or exceeds ``timeout_s`` fails the attempt and the
    request is *hedged* to the next-freshest replica; a full pass over the
    candidates backs off ``backoff_s * 2**attempt`` and retries, up to
    ``max_retries`` extra passes. Repeated failures open a per-replica
    circuit breaker (``breaker_failures`` consecutive misses skip it for
    ``breaker_cooldown`` requests, then one half-open probe) so a flapping
    replica stops eating the hedge budget. Every response carries the
    serving replica's ``tick`` and its ``staleness`` vs the freshest live
    candidate (:class:`RouteResult`) — stale answers are served, but never
    silently.
    """

    def __init__(self, replicas: List[SuggestFrontend], *,
                 timeout_s: Optional[float] = None, max_retries: int = 1,
                 backoff_s: float = 0.0, breaker_failures: int = 3,
                 breaker_cooldown: int = 16):
        self.replicas = replicas
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._rr = itertools.count()
        self._clock = 0
        self._breakers = [_Breaker(breaker_failures, breaker_cooldown)
                          for _ in replicas]
        # observability: the chaos bench reads these
        self.n_requests = 0
        self.n_hedged = 0
        self.n_failures = 0     # individual replica attempt failures
        self.n_timeouts = 0
        self.n_breaker_skips = 0

    @staticmethod
    def _fresh(r) -> int:
        f = getattr(r, "freshness_tick", None)
        if f is None:
            return -1
        tick = f()
        return -1 if tick is None else int(tick)

    def _candidates(self) -> Tuple[List[int], int]:
        """Live replica indices in try-order + the freshest live tick.
        Freshest first; round-robin rotation within the leading equal-
        freshness group; breaker-open replicas demoted to last resort."""
        live = [i for i, r in enumerate(self.replicas) if r.alive]
        if not live:
            raise RuntimeError("no live frontend replicas")
        fresh = {i: self._fresh(self.replicas[i]) for i in live}
        live.sort(key=lambda i: (-fresh[i], i))
        top = [i for i in live if fresh[i] == fresh[live[0]]]
        if len(top) > 1:           # spread load over equally-fresh replicas
            rot = next(self._rr) % len(top)
            live[:len(top)] = top[rot:] + top[:rot]
        closed = [i for i in live if self._breakers[i].allow(self._clock)]
        demoted = [i for i in live if i not in closed]
        self.n_breaker_skips += len(demoted)
        return closed + demoted, max(fresh.values())

    def request_info(self, query: str, k: int = 8) -> RouteResult:
        """Route one request; raises RuntimeError only when every live
        replica failed every retry pass (or none is live at all)."""
        self._clock += 1
        self.n_requests += 1
        now = self._clock
        order, max_fresh = self._candidates()
        n_tried = 0
        errors: List[str] = []
        for attempt in range(self.max_retries + 1):
            if attempt > 0 and self.backoff_s > 0:
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            for i in order:
                r = self.replicas[i]
                if not r.alive:      # died mid-pass
                    continue
                n_tried += 1
                t0 = time.perf_counter()
                try:
                    sugg = r.related(query, k)
                except Exception as e:   # noqa: BLE001 — any replica fault
                    self.n_failures += 1
                    self._breakers[i].record(False, now)
                    errors.append(f"replica {i}: {type(e).__name__}: {e}")
                    continue
                if (self.timeout_s is not None
                        and time.perf_counter() - t0 > self.timeout_s):
                    # too slow counts as failure: the answer is discarded
                    # and the request hedges to the next-freshest replica
                    self.n_failures += 1
                    self.n_timeouts += 1
                    self._breakers[i].record(False, now)
                    errors.append(f"replica {i}: timeout")
                    continue
                self._breakers[i].record(True, now)
                tick = self._fresh(r)
                hedged = n_tried > 1
                self.n_hedged += int(hedged)
                return RouteResult(
                    suggestions=sugg, replica=i,
                    tick=None if tick < 0 else tick,
                    staleness=(None if tick < 0 or max_fresh < 0
                               else max_fresh - tick),
                    hedged=hedged, attempts=n_tried)
        raise RuntimeError(
            f"no live frontend replicas answered after {n_tried} attempts: "
            + "; ".join(errors[-len(order):]))

    def request(self, query: str, k: int = 8) -> List[Tuple[str, float]]:
        return self.request_info(query, k).suggestions

"""Self-healing replicated serving fleet (paper §4.2, operationalized).

The paper's production story is a *fleet*: backend instances are
"replicated for fault tolerance, but not sharded", leader election picks
the single writer, frontends keep serving "the most recently persisted
results" while a restarted instance rewinds into the hose and catches up
faster than real time. The durable log, bit-exact ``recover_service``,
delta snapshots, ``ReplicaGroup`` election and log compaction are each
ingredients; this module is the control plane that stitches them into a
fleet that keeps answering through node deaths:

  * **heartbeat failure detection** — a replica heartbeats by processing
    ticks; one that has not stepped for ``heartbeat_timeout`` ticks is
    declared dead (``ReplicaGroup.fail``). Detection is tick-clocked, so
    the whole fleet is deterministic under test.
  * **epoch-fenced leader failover** — the leader is the single durable-log
    writer. Every leadership change bumps ``ReplicaGroup.epoch``; the new
    leader stamps that epoch into the log manifest
    (``FirehoseLogWriter.assume_epoch``) *before* its first append, so a
    paused/partitioned ex-leader that wakes up and tries to append is
    rejected with ``WriterFencedError`` — its stray segment never lands.
  * **log heal on failover** — ticks the dead leader had buffered (or that
    arrived while its death went undetected) never reached the manifest.
    Every replica keeps a short in-memory ring of recent raw ticks (host
    arrays, which neither the engines nor the log writer mutate); the new
    leader re-appends the missing range from its ring, so the durable log
    stays gap-free and recovery stays bit-exact. Only if the outage
    outlives the ring does the fleet lose ticks (counted).
  * **self-healing** — a dead replica restarts after ``restart_after``
    ticks via ``streaming.replay.recover_service`` (snapshot restore +
    faster-than-real-time log-tail replay), then catches up incrementally
    (``catchup_budget_ticks`` per fleet tick) and is readmitted to query
    routing only once its lag is <= ``readmit_lag`` ticks.
  * **hedged query routing** — ``serverset()`` wraps the replicas in
    ``serving.serve.ServerSet``: freshest-first ordering, retry/backoff,
    hedged second requests and per-replica circuit breakers. A crashed-
    but-undetected replica surfaces as a connection error that the hedge
    absorbs: client requests keep succeeding through kills and failovers.

Port of the JAX package's ``distributed/fleet.py``. Each replica owns its
``AssistanceService`` and so its engines' tensors (the port's stores
write in place: replicas never share a state). Engines live on the
fleet's ``device``, CUDA unless the caller names another. A killed
replica's service is dropped with its last reference, so its tensors are
freed before the restart builds new ones. ``FleetConfig.alpha`` and
``log_name`` are kept for the JAX signature and accept only the port's
constants (``core.background.ALPHA``, ``streaming.log.LOG_NAME``).
"""
from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

from ..core.background import ALPHA, AssistanceService, background_config
from ..core.engine import EngineConfig
from ..core.hashing import fingerprint
from ..core.stores import resolve_device
from ..serving.serve import ServerSet
from ..streaming.compaction import CompactionConfig, LogCompactor
from ..streaming.log import (LOG_NAME, FirehoseLogReader, FirehoseLogWriter,
                             WriterFencedError, kill_writer_mid_segment)
from ..streaming.replay import (CatchUpController, ReplayConfig,
                                recover_service)
from .fault_tolerance import CheckpointManager, ReplicaGroup


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    n_replicas: int = 3
    heartbeat_timeout: int = 2   # missed ticks before a replica is declared dead
    restart_after: int = 1       # ticks dead before the self-heal restart kicks in
    readmit_lag: int = 0         # max lag_ticks to rejoin query routing
    catchup_budget_ticks: Optional[int] = None  # replay ticks per fleet tick
                                                # while recovering (None = all)
    snapshot_every: int = 8      # leader persists both engines at this cadence
    ticks_per_segment: int = 4
    keep_segments: int = 0       # 0 = retain the whole log (bit-exact restarts)
    full_interval: int = 1       # delta-snapshot chain interval
    recent_ticks: int = 32       # log-heal ring length (raw ticks per replica)
    chunk_ticks: int = 8         # replay chunk size
    rank_lag_ticks: int = 4
    alpha: float = ALPHA         # only the port's constant is accepted
    log_name: str = LOG_NAME     # only the port's constant is accepted
    compact_every: int = 0       # fold the log into a base snapshot at this
                                 # cadence (0 = no compaction); leader-only,
                                 # epoch-fenced like the writer
    keep_bases: int = 2          # compaction fallback depth (old bases +
                                 # their log tail retained after each swap)

    def __post_init__(self):
        if self.alpha != ALPHA:
            raise ValueError(f"alpha must be {ALPHA} (core.background.ALPHA),"
                             f" not {self.alpha}")
        if self.log_name != LOG_NAME:
            raise ValueError(f"log_name must be {LOG_NAME!r} "
                             f"(streaming.log.LOG_NAME), not "
                             f"{self.log_name!r}")


class _Replica:
    __slots__ = ("rid", "service", "writer", "status", "last_heartbeat",
                 "down_since", "recent", "n_restarts", "last_recovery")

    def __init__(self, rid: int, service: AssistanceService, recent_ticks: int):
        self.rid = rid
        self.service: Optional[AssistanceService] = service
        self.writer: Optional[FirehoseLogWriter] = None
        self.status = "live"            # live | dead | recovering
        self.last_heartbeat = -1
        self.down_since: Optional[int] = None
        self.recent: collections.deque = collections.deque(
            maxlen=recent_ticks)    # (tick, events, tweets) log-heal ring
        self.n_restarts = 0
        self.last_recovery: Optional[Dict] = None   # recover_service stats


class ReplicaHandle:
    """The frontend-facing view of one fleet replica, duck-typed for
    ``ServerSet`` (``alive`` / ``related`` / ``freshness_tick``).

    ``alive`` reflects the *detected* membership view (a dead or still-
    catching-up replica is skipped outright); a crashed replica whose
    death has not been detected yet still looks alive — exactly like a
    real serverset — and its ``related`` raises ``ConnectionError``, which
    the router's hedge absorbs. Queries may be query strings or raw
    query fingerprints; suggestions come back as (dst_fp, score) pairs.
    The handle holds the fleet, never a service.
    """

    def __init__(self, fleet: "ServingFleet", rid: int):
        self._fleet = fleet
        self.rid = rid

    @property
    def alive(self) -> bool:
        return self._fleet._replicas[self.rid].status == "live"

    def freshness_tick(self) -> Optional[int]:
        rep = self._fleet._replicas[self.rid]
        if rep.service is None:
            return None
        return int(rep.service.rt.state.tick)

    def related(self, query, k: int = 8) -> List[Tuple[int, float]]:
        rep = self._fleet._replicas[self.rid]
        if rep.service is None:
            raise ConnectionError(f"replica {self.rid} is down")
        fp = (fingerprint(" ".join(query.lower().split()))
              if isinstance(query, str) else int(query))
        return rep.service.suggest_fp(fp, k)


class ServingFleet:
    """N replicated serving stacks + one durable log + shared snapshots.

    Drive it with ``offer_tick(t, events, tweets)`` once per micro-batch
    tick; inject failures with ``kill``; route queries through
    ``serverset()``. All liveness decisions are tick-clocked (no wall
    time), so a chaos run is exactly reproducible — and the surviving /
    recovered replicas' engine states are bit-exact against an
    uninterrupted single-service run over the same stream.

    Engines, restarts and compaction folds run on ``device``: CUDA unless
    the caller names another, raising where CUDA is asked for and absent.
    """

    def __init__(self, root_dir: str, rt_cfg: EngineConfig,
                 cfg: FleetConfig = FleetConfig(), *,
                 bg_cfg: Optional[EngineConfig] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rt_cfg = rt_cfg
        self.bg_cfg = bg_cfg if bg_cfg is not None \
            else background_config(rt_cfg)
        self.log_dir = os.path.join(root_dir, "log")
        self.rt_ckpt = CheckpointManager(os.path.join(root_dir, "rt"),
                                         full_interval=cfg.full_interval)
        self.bg_ckpt = CheckpointManager(os.path.join(root_dir, "bg"),
                                         full_interval=cfg.full_interval)
        self.group = ReplicaGroup(cfg.n_replicas, self.rt_ckpt)
        self.rcfg = ReplayConfig(chunk_ticks=cfg.chunk_ticks,
                                 rank_lag_ticks=cfg.rank_lag_ticks)
        # one service (two engines, their own tensors) per replica
        self._replicas = [
            _Replica(i, AssistanceService(rt_cfg, bg_cfg=self.bg_cfg,
                                          device=self.device),
                     cfg.recent_ticks)
            for i in range(cfg.n_replicas)]
        self.handles = [ReplicaHandle(self, i) for i in range(cfg.n_replicas)]
        self._reader = FirehoseLogReader(self.log_dir)
        # compaction (leader-only; the compactor re-adopts the group epoch
        # before every cycle so a deposed leader's fold can never swap the
        # manifest — see streaming.compaction)
        self.compactor: Optional[LogCompactor] = None
        if cfg.compact_every > 0:
            self.compactor = LogCompactor(
                self.log_dir, {"rt": rt_cfg, "bg": self.bg_cfg},
                cfg=CompactionConfig(keep_bases=cfg.keep_bases,
                                     chunk_ticks=cfg.chunk_ticks),
                device=self.device)
        self.n_compactions = 0
        self.last_compaction: Optional[Dict] = None
        # counters (the chaos runs read these)
        self.n_failovers = 0
        self.n_deaths_detected = 0
        self.n_recoveries = 0
        self.n_healed_ticks = 0
        self.n_lost_ticks = 0
        self.n_unlogged_pending = 0   # ticks awaiting log heal right now
        self._ensure_leader()

    # ---- membership / leadership ----
    def leader(self) -> Optional[int]:
        return self.group.leader()

    def _new_writer(self) -> FirehoseLogWriter:
        return FirehoseLogWriter(self.log_dir,
                                 ticks_per_segment=self.cfg.ticks_per_segment,
                                 keep_segments=self.cfg.keep_segments)

    def _ensure_leader(self) -> Optional[_Replica]:
        """Make sure the elected leader owns a writer stamped at the
        current epoch; heal the log from its recent-tick ring on takeover."""
        lead = self.group.leader()
        if lead is None:
            return None
        rep = self._replicas[lead]
        if rep.writer is None:
            rep.writer = self._new_writer()
        if rep.writer.epoch != self.group.epoch:
            rep.writer.assume_epoch(self.group.epoch)   # the fence lands here
            self.n_failovers += 1
            self._heal_log(rep)
        return rep

    def _heal_log(self, rep: _Replica) -> None:
        """Re-append ticks the old leader never sealed, from the new
        leader's in-memory ring — the durable log stays gap-free so
        recovery stays bit-exact. Ticks older than the ring are lost
        (counted, paper §4.2 stance)."""
        w = rep.writer
        last = w.last_tick
        start = 0 if last is None else last + 1
        ring = {t: (ev, tw) for t, ev, tw in rep.recent}
        if ring:
            for t in range(start, max(ring) + 1):
                if t in ring:
                    ev, tw = ring[t]
                    w.append(t, ev, tw)
                    self.n_healed_ticks += 1
                else:
                    self.n_lost_ticks += 1

    def detect(self, t: int) -> List[int]:
        """Tick-clocked failure detection: declare replicas dead after
        ``heartbeat_timeout`` missed ticks; fail over leadership (epoch
        bump + fence + log heal) when the dead one led."""
        died = []
        for rep in self._replicas:
            if rep.status == "live" and rep.service is None \
                    and t - rep.last_heartbeat > self.cfg.heartbeat_timeout:
                rep.status = "dead"
                rep.down_since = t
                self.group.fail(rep.rid)
                self.n_deaths_detected += 1
                died.append(rep.rid)
        if died:
            self._ensure_leader()
        return died

    # ---- failure injection ----
    def kill(self, rid: int, mid_segment: bool = False) -> Optional[str]:
        """Crash a replica: its memory-resident engines are gone (their
        tensors freed with the service's last reference), its heartbeats
        stop (death is *detected* later, by timeout). With ``mid_segment``
        (leader only) the writer dies mid-segment write, leaving a torn
        unmanifested file — ``kill_writer_mid_segment`` — and stays on the
        replica, dead: its appends raise until a takeover re-fences it.
        Returns the torn file name, if any."""
        rep = self._replicas[rid]
        torn = None
        if mid_segment and rep.writer is not None:
            torn = kill_writer_mid_segment(rep.writer)
        rep.service = None
        rep.recent.clear()
        rep.writer = None if not mid_segment else rep.writer
        if rep.status == "recovering":
            # crashed again mid catch-up: already out of membership, so no
            # detection round-trip — straight back to dead, restart later
            rep.status = "dead"
        return torn

    # ---- the tick loop ----
    def offer_tick(self, t: int, events=None, tweets=None) -> Dict:
        """One fleet tick: detect failures, append to the fenced log,
        step every live replica, heal the dead ones, persist on cadence."""
        info: Dict[str, Any] = {"tick": t, "died": [], "recovered": [],
                                "appended": False}
        info["died"] = self.detect(t)

        # durable append first (leader-elected single writer, fenced) —
        # durability precedes state mutation, same ordering as the
        # overload controller's admitted-stream logging.
        lead = self.group.leader()
        if lead is not None:
            rep = self._ensure_leader()
            try:
                info["appended"] = self.group.log_append(
                    lead, rep.writer, t, events, tweets)
            except WriterFencedError:
                raise   # a fenced fleet-driven append is a logic error
            except RuntimeError:
                # crashed-but-undetected leader: its writer is dead. The
                # tick reaches every live replica's heal ring and the log
                # is healed at failover.
                info["appended"] = False
        if not info["appended"]:
            self.n_unlogged_pending += 1
        else:
            self.n_unlogged_pending = 0

        # every live replica consumes the hose (replicated, not sharded)
        for rep in self._replicas:
            if rep.status == "live" and rep.service is not None:
                assert int(rep.service.rt.state.tick) == t, \
                    f"replica {rep.rid} out of phase"
                rep.service.step(events, tweets)
                rep.recent.append((t, events, tweets))
                rep.last_heartbeat = t

        # self-healing: restart the dead, top up the recovering, readmit
        info["recovered"] = self._heal_replicas(t)

        # leader persists both engines on cadence (single-writer persist)
        if info["appended"] and self.cfg.snapshot_every > 0 \
                and (t + 1) % self.cfg.snapshot_every == 0:
            leader_rep = self._replicas[self.group.leader()]
            if leader_rep.service is not None:
                leader_rep.service.save_snapshot(self.rt_ckpt, self.bg_ckpt)

        # leader folds the sealed log into a base on cadence: retention
        # becomes [base, head] while replay-from-zero stays possible. Only
        # an *appending* leader compacts (same single-writer discipline),
        # and the compactor re-adopts the current epoch so its manifest
        # swap is fenced against any failover since the fold started.
        if self.compactor is not None and info["appended"] \
                and (t + 1) % self.cfg.compact_every == 0:
            self.compactor.assume_epoch(self.group.epoch)
            stats = self.compactor.compact()
            self.last_compaction = stats
            if not stats.get("noop"):
                self.n_compactions += 1
                info["compacted"] = stats["floor"]
        return info

    def _catchup_target(self, cur: int, head: Optional[int]) -> Optional[int]:
        if head is None:
            return cur
        budget = self.cfg.catchup_budget_ticks
        return head + 1 if budget is None else min(head + 1, cur + budget)

    def _heal_replicas(self, t: int) -> List[int]:
        readmitted = []
        for rep in self._replicas:
            if rep.status == "dead" and rep.down_since is not None \
                    and t - rep.down_since >= self.cfg.restart_after:
                self._restart(rep)
            elif rep.status == "recovering":
                self._continue_catchup(rep, t)
            if rep.status == "recovering" and self._lag(rep, t) \
                    <= self.cfg.readmit_lag:
                # lag cleared: rejoin membership AND query routing
                rep.status = "live"
                rep.last_heartbeat = t
                rep.down_since = None
                self.group.recover(rep.rid)
                self._ensure_leader()   # may retake leadership (epoch bump)
                rep.service.refresh_cache()
                self.n_recoveries += 1
                readmitted.append(rep.rid)
        return readmitted

    def _restart(self, rep: _Replica) -> None:
        """Cold restart via the whole-stack recovery path: snapshot
        restore + log-tail replay, ranking suppressed until the lag
        clears. The replica is NOT yet routed to (status ``recovering``)."""
        service, stats = recover_service(
            self.rt_cfg, self.rt_ckpt, self.bg_ckpt, self.log_dir,
            self.rcfg, bg_cfg=self.bg_cfg, device=self.device)
        rep.service = service
        rep.status = "recovering"
        rep.n_restarts += 1
        rep.last_recovery = stats

    def _continue_catchup(self, rep: _Replica, t: int) -> None:
        self._reader.refresh()
        head = self._reader.last_tick()
        for eng in (rep.service.rt, rep.service.bg):
            cur = int(eng.state.tick)
            target = self._catchup_target(cur, head)
            if target > cur:
                CatchUpController(eng, self._reader, self.rcfg).catch_up(
                    target, refresh=False)
        # no heal-ring refill here: a recovering replica only learns ticks
        # FROM the log, so its ring could never heal anything the log lacks.
        # It re-arms the ring with live ticks once readmitted.

    def _lag(self, rep: _Replica, t: int) -> int:
        if rep.service is None:
            return t + 1
        return (t + 1) - int(rep.service.rt.state.tick)

    # ---- client side ----
    def serverset(self, **kw) -> ServerSet:
        """A hedged, circuit-broken ``ServerSet`` over the fleet replicas."""
        return ServerSet(self.handles, **kw)

    # ---- observability ----
    def metrics(self) -> Dict:
        self._reader.refresh()
        head = self._reader.last_tick()
        reps = {}
        for rep in self._replicas:
            reps[rep.rid] = {
                "status": rep.status,
                "last_heartbeat": rep.last_heartbeat,
                "tick": (None if rep.service is None
                         else int(rep.service.rt.state.tick)),
                "n_restarts": rep.n_restarts,
            }
        return {
            "leader": self.group.leader(),
            "epoch": self.group.epoch,
            "log_head_tick": head,
            "log_floor_tick": self._reader.floor_tick(),
            "n_log_bases": len(self._reader.bases),
            "n_compactions": self.n_compactions,
            "n_failovers": self.n_failovers,
            "n_deaths_detected": self.n_deaths_detected,
            "n_recoveries": self.n_recoveries,
            "n_healed_ticks": self.n_healed_ticks,
            "n_lost_ticks": self.n_lost_ticks,
            "replicas": reps,
        }

    def states(self) -> Dict[int, Tuple[Any, Any]]:
        """Per-replica (rt, bg) engine states (bit-exactness assertions)."""
        return {rep.rid: (rep.service.rt.state, rep.service.bg.state)
                for rep in self._replicas if rep.service is not None}

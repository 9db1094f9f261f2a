"""End-to-end search-assistance service launcher (paper Figure 4).

Runs the deployed architecture on a synthetic stream (the
``steve_jobs_scenario`` event) or on the flash-crowd firehose workload:
backend engine replicas consuming the query hose + firehose,
leader-elected persistence every rank cycle, frontend replicas polling
for fresh results behind a ``ServerSet``, the background model +
interpolation, and a periodic spelling job (every 60 ticks,
``edit_distance`` on the card).

The stack is **restartable end to end**: the elected leader appends every
tick to a durable firehose log and snapshots BOTH engine states (real-time
and background) into delta-chained checkpoint dirs (changed slots only
between fulls — ``--full-every``). Kill the process and relaunch with
``--recover`` and it restores both engines from their snapshot chains,
replays the shared log tail faster than real time (ranking suppressed per
engine until its lag clears), rebuilds the interpolation cache, and keeps
serving from where it left off. A crash loses the ticks the log writer
still buffered (the segment not yet sealed); the resumed run takes them
again from the hose, from the recovered engines' tick on, so a crashed
and resumed run ends as the uncrashed one would. (The JAX launcher draws
the resumed ticks of the synthetic stream from a fresh stream, whose draws
depend on every earlier tick: its resumed tick t is not the uncrashed
run's tick t. The firehose workload is pure in ``(seed, t)``, so there
both launchers draw no dropped ticks.)

With ``--slo-ms`` set the live path runs under the overload controller
(``streaming/overload.py``): lag-adaptive micro-batching through
``step_many`` plus the degradation ladder (shed rt ranking -> stretch bg
ranking -> admission-control ingest), every shed counted and surfaced in
the status line; the controller drives the leader rt engine and the bg
engine, with the follower replicas as mirrors. ``--workload firehose``
swaps the synthetic stream for the flash-crowd workload generator
(``--spike-mult`` x volume at ``--spike-at``), ``--tick-ms`` paces
simulated arrivals so falling behind real time shows up as lag, and
``--slow-io-ms`` injects disk latency into the log writer (chaos knob).
With ``--compact-every N`` the leader folds the sealed log into base
snapshots every N ticks (``streaming/compaction.py``): on-disk log bytes
stay bounded while replay-from-zero survives via the newest base.
``--autotune`` tunes first (``launch/autotune.py``: each hot path's kernel
and twin timed, cached per device and shape class), prints the plan's
variants and writes the plan into the persisted tables' meta, where the
frontends' ``metrics()["tuned_variants"]`` report it. The plan routes
nothing: the engine runs the same with or without it.

With ``--fleet N`` the run switches to the self-healing replicated fleet
(``distributed.fleet.ServingFleet``): N full serving stacks replaying one
leader-written, epoch-fenced durable log, heartbeat failure detection,
lag-gated readmission, and hedged staleness-aware routing. The chaos
knobs ``--kill-leader-at`` (mid-segment) and ``--kill-follower-at``
demonstrate failover and self-healing live; requests keep being answered
throughout. The fleet path reads ``--compact-every`` and ``--keep-bases``
and ignores the single-stack flags; the kill flags do nothing without
``--fleet``.

  python -m repro_torch.launch.serve_assist --ticks 120 --out /tmp/assist
  python -m repro_torch.launch.serve_assist --ticks 120 --out /tmp/assist --recover
  python -m repro_torch.launch.serve_assist --device cpu --ticks 61 \\
      --out /tmp/assist_t --crash-at 40
  python -m repro_torch.launch.serve_assist --ticks 120 --out /tmp/assist \\
      --slo-ms 80 --workload firehose --spike-mult 50 --tick-ms 40 \\
      --compact-every 16
  python -m repro_torch.launch.serve_assist --ticks 24 --out /tmp/assist_at \\
      --autotune
  python -m repro_torch.launch.serve_assist --ticks 48 --out /tmp/assist_f \\
      --fleet 3 --workload firehose --spike-at 6 \\
      --kill-leader-at 7 --kill-follower-at 12

Port of the JAX package's ``launch/serve_assist.py``. The single-stack
loop is :func:`run` and the fleet's is :func:`run_fleet` (each takes the
engine config, the base stream config, :class:`AssistOptions` and a
device); :func:`main` calls one of them with the JAX file's own settings.
Engines run on CUDA unless ``--device`` names another device.
``--use-kernel`` is not carried over: on CUDA every hot path runs its
kernel, and the port's ``SpellConfig`` has no ``use_kernel`` field.

After ``--recover`` the follower replicas take copies of the recovered
leader's state (JAX shares one immutable state between them): the port's
stores write their tensors in place, so replicas never share one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import stores
from ..core.background import AssistanceService, background_config
from ..core.engine import EngineConfig, SearchAssistanceEngine, clone_state
from ..core.hashing import join_fp
from ..core.plan import TunedPlan
from ..core.spelling import SpellConfig, spelling_cycle
from ..data.stream import StreamConfig, SyntheticStream, steve_jobs_scenario
from ..distributed.fault_tolerance import CheckpointManager, ReplicaGroup
from ..distributed.fleet import FleetConfig, ServingFleet
from ..serving.serve import ServerSet, SuggestFrontend, pack_suggestions
from ..streaming import (CompactionConfig, FirehoseLogReader,
                         FirehoseLogWriter, FirehoseWorkload, LogCompactor,
                         ReplayConfig, SLOConfig, SpamSpec, SpikeSpec,
                         WorkloadConfig, recover_service, slow_io)
from ..streaming.compaction import base_dir

SPELL_EVERY = 60          # ticks between spelling jobs
REQUEST_EVERY = 12        # ticks between the head query's requests
TICKS_PER_SEGMENT = 8     # the durable log's segment length
FIREHOSE_HEAD = "breaking0 term0"   # the firehose workload's head query


@dataclasses.dataclass(frozen=True)
class AssistOptions:
    """The run's options, one per CLI flag. The first eight have no
    defaults; overload control, the firehose workload, compaction and the
    fleet default to off, as their flags do."""
    ticks: int
    out: str
    replicas: int
    fail_replica_at: int    # tick at which backend replica 0 dies (-1: never)
    crash_at: int           # tick after which the whole stack exits (-1: never)
    recover: bool           # restore rt + bg and replay the log first
    full_every: int         # snapshot chain: a full every N snapshots
    slow_io_ms: float       # latency injected into every log seal
    slo_ms: float = 0.0     # overload control's step-latency SLO (0: off)
    tick_ms: float = 0.0    # simulated arrival budget a tick (0: no pacing)
    workload: str = "synthetic"   # or "firehose"
    spike_at: int = 30      # firehose: the flash crowd's onset tick
    spike_mult: float = 50.0      # firehose: its peak volume multiplier
    compact_every: int = 0  # fold the log into bases every N ticks (0: off)
    keep_bases: int = 2     # compaction fallback depth
    fleet: int = 0          # replicas of the self-healing fleet (0: off)
    kill_leader_at: int = -1      # fleet: kill the leader mid-segment here
    kill_follower_at: int = -1    # fleet: kill a live follower here
    # the tuner's plan (--autotune), written into the persisted tables'
    # meta; it routes nothing (``core/plan.py``)
    plan: Optional[TunedPlan] = None


def default_configs():
    """The JAX launcher's own settings: (engine config, base stream
    config)."""
    return (EngineConfig(query_capacity=1 << 14, cooc_capacity=1 << 17,
                         session_capacity=1 << 14, decay_every=6,
                         rank_every=12),
            StreamConfig(vocab_size=2048, queries_per_tick=1024,
                         tweets_per_tick=128))


def firehose_workload(spike_at: int, spike_mult: float) -> FirehoseWorkload:
    """The JAX launcher's flash-crowd workload (seed 0): 1,024 queries and
    64 tweets a tick at base, one breaking-news spike, spam bursts."""
    return FirehoseWorkload(WorkloadConfig(
        base_queries_per_tick=1024, base_tweets_per_tick=64,
        spikes=(SpikeSpec(t_start=spike_at, mult=spike_mult),),
        spam=SpamSpec()), seed=0)


def _fmt(v, nd: int = 1):
    """Status-line formatting: a missing signal prints as '?', not None
    (lag is None before the first log segment seals; latency percentiles
    are None before the first overload-meta persist)."""
    if v is None:
        return "?"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _hose(opts: AssistOptions, stream_cfg: StreamConfig):
    """The run's hose: (gen_tick, tokenizer, whether gen_tick is pure in
    t, head query, the tick from which it is asked)."""
    if opts.workload == "firehose":
        wl = firehose_workload(opts.spike_at, opts.spike_mult)
        return wl.gen_tick, wl.tok, True, FIREHOSE_HEAD, opts.spike_at
    if opts.workload == "synthetic":
        scfg, event = steve_jobs_scenario(base_cfg=stream_cfg)
        stream = SyntheticStream(scfg, seed=0)
        return (stream.gen_tick, stream.tok, False, event.terms[0],
                event.t_start)
    raise ValueError(f"unknown workload {opts.workload!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _disk_bytes(log_dir: str) -> Dict[str, int]:
    """Bytes on disk of the log's segment files and of its bases."""
    seg = sum(os.path.getsize(os.path.join(log_dir, f))
              for f in os.listdir(log_dir) if f.endswith(".npz"))
    bases = 0
    for root, _, files in os.walk(base_dir(log_dir, "")):
        bases += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return {"segments": seg, "bases": bases}


def follower_replicas(leader: SearchAssistanceEngine, cfg: EngineConfig,
                      n: int) -> List[SearchAssistanceEngine]:
    """``n`` follower rt replicas of a recovered leader, each with its own
    copy of the leader's state and tables, on the leader's device."""
    out = []
    for i in range(1, n + 1):
        eng = SearchAssistanceEngine(cfg, name=f"rt{i}", device=leader.device)
        eng.state = clone_state(leader.state)
        eng.suggestions = dict(leader.suggestions)
        out.append(eng)
    return out


def run(ecfg: EngineConfig, stream_cfg: StreamConfig, opts: AssistOptions,
        device="cuda", *, log: Callable[[str], None] = print) -> Dict:
    """Drive the whole serving stack for ticks ``[start, opts.ticks)``.

    ``stream_cfg`` is the base stream the ``steve_jobs_scenario`` event is
    added to (seed 0) under the synthetic workload; the firehose workload
    is :func:`firehose_workload`. Returns the live stack (``backends``,
    ``bg``, ``service`` — the overload-controlled ``AssistanceService``
    or None —, ``writer``, ``compactor``, ``frontends``, ``serverset``,
    ``tok``, ``head``), ``start_tick``, ``recover`` (``recover_service``'s
    stats and ``wall_s``, or None), ``crashed_at`` (or None),
    ``skip_draw_ms`` (the resumed run's draws of the synthetic stream's
    ticks before its first), ``overload`` (the controller's final
    ``stats_snapshot()`` after its drain, or None), and per-event
    records: ``ticks`` (``t``; ``draw_ms``: the tick's draw; ``steps_ms``:
    log append and engine steps, synced; ``poll_ms``: the frontends'
    polls; ``stack_ms``, their sum; ``persist_ms``; ``compact_ms``;
    ``spell_ms``; ``request_ms``; under overload control ``overload``:
    the ladder's level after the offer, the lag hint, the backlog, and
    the tick's offered, shed and logged queries and tweets), ``saves``
    (each engine's snapshot kind, bytes and ms; ``heartbeat``),
    ``compactions`` (``compact()``'s stats and the log's bytes on disk
    before and after), ``spelling`` and ``requests`` (``RouteResult`` and
    the first frontend's ``metrics()``).
    """
    device = stores.resolve_device(device)
    gen_tick, tok, pure, head, head_t0 = _hose(opts, stream_cfg)
    bgcfg = background_config(ecfg, rank_every_mult=3)

    rt_dir = os.path.join(opts.out, "rt")
    bg_dir = os.path.join(opts.out, "bg")
    spell_dir = os.path.join(opts.out, "spell")
    log_dir = os.path.join(opts.out, "log")
    rt_group = ReplicaGroup(opts.replicas, CheckpointManager(rt_dir))
    # engine-STATE snapshots (the recovery path): delta-chained so the
    # cadence can match every rank cycle without a write-volume blowup
    state_rt_ckpt = CheckpointManager(os.path.join(opts.out, "state", "rt"),
                                      keep_n=4, full_interval=opts.full_every)
    state_bg_ckpt = CheckpointManager(os.path.join(opts.out, "state", "bg"),
                                      keep_n=4, full_interval=opts.full_every)
    res: Dict = {"start_tick": 0, "recover": None, "crashed_at": None,
                 "overload": None, "ticks": [], "saves": [],
                 "compactions": [], "spelling": [], "requests": [],
                 "tok": tok, "head": head}

    if opts.recover:
        # recover_service handles engines with no snapshot yet (a crash
        # before the first persist): they cold-start and replay the whole
        # retained log (from the newest compaction base, if one is
        # advertised), so resume always lands past the logged ticks.
        # allow_gap: a snapshot can be newer than the log's surviving tail
        # (unflushed ticks died with the crash) — resuming appends past the
        # hole is the paper's stance (§4.2: losing a little state is
        # tolerable), and later recoveries skip it instead of failing.
        FirehoseLogReader(log_dir).repair()   # drop torn-tail debris
        t0 = time.perf_counter()
        svc, rstats = recover_service(
            ecfg, state_rt_ckpt, state_bg_ckpt, log_dir,
            ReplayConfig(chunk_ticks=8, allow_gap=True), bg_cfg=bgcfg,
            device=device)
        _sync(device)
        dt = time.perf_counter() - t0
        res["recover"] = dict(rstats, wall_s=dt)
        log(f"[recover] rt: replayed {rstats['rt']['n_ticks']} ticks from "
            f"snapshot {rstats['rt']['restored_step']}, bg: "
            f"{rstats['bg']['n_ticks']} ticks from "
            f"{rstats['bg']['restored_step']} "
            f"(fell_back={rstats['bg']['restore'].get('fell_back')}); "
            f"{dt:.1f}s to fresh tables")
        backends = [svc.rt] + follower_replicas(svc.rt, ecfg,
                                                opts.replicas - 1)
        bg_engine = svc.bg
        del svc
        res["start_tick"] = int(backends[0].state.tick)
    else:
        backends = [SearchAssistanceEngine(ecfg, name=f"rt{i}", device=device)
                    for i in range(opts.replicas)]
        bg_engine = SearchAssistanceEngine(bgcfg, name="bg", device=device)

    writer = FirehoseLogWriter(log_dir, ticks_per_segment=TICKS_PER_SEGMENT,
                               keep_segments=16)
    if opts.slow_io_ms > 0:
        slow_io(writer, ("flush",), opts.slow_io_ms / 1e3)
    compactor = None
    if opts.compact_every > 0:
        # folds under the names recover_service restores ("rt"/"bg")
        compactor = LogCompactor(
            log_dir, {"rt": ecfg, "bg": bgcfg},
            cfg=CompactionConfig(keep_bases=opts.keep_bases), device=device)
    bg_ckpt = CheckpointManager(bg_dir)
    spell_ckpt = CheckpointManager(spell_dir)
    frontends = [SuggestFrontend(rt_dir, bg_dir, tok,
                                 spell_dir=spell_dir, log_dir=log_dir)
                 for _ in range(2)]
    serverset = ServerSet(frontends)
    # overload control (--slo-ms): one controller drives the whole stack —
    # leader rt engine + bg engine, with the follower replicas as mirrors
    # fed the same flushed stacks (each holds its own state)
    svc = None
    if opts.slo_ms > 0:
        svc = AssistanceService(rt=backends[0], bg=bg_engine,
                                slo=SLOConfig(slo_ms=opts.slo_ms),
                                mirrors=backends[1:])
    res.update(backends=backends, bg=bg_engine, service=svc, writer=writer,
               compactor=compactor, frontends=frontends, serverset=serverset)
    logged = {"events": 0, "tweets": 0}

    def log_all(tick, ev_a, tw_a):
        # the elected leader appends (the admitted batch, under overload
        # control) to the durable log before ingestion
        for rid in rt_group.live():
            rt_group.log_append(rid, writer, tick, ev_a, tw_a)
        logged["events"] += 0 if ev_a is None else int(
            np.asarray(ev_a.valid, bool).sum())
        logged["tweets"] += 0 if tw_a is None else int(
            np.asarray(tw_a.valid, bool).sum())

    def save_states(t, rt_eng, heartbeat, extra_meta=None):
        # the leader snapshots BOTH engine states (delta-chained) so a
        # crashed stack restores rt AND bg
        save = {"t": t, "heartbeat": heartbeat}
        if opts.plan is not None:   # the plan rides the snapshots, as in JAX
            extra_meta = {**(extra_meta or {}), "plan": opts.plan.to_json()}
        for label, e, ck in (("rt", rt_eng, state_rt_ckpt),
                             ("bg", bg_engine, state_bg_ckpt)):
            s0 = time.perf_counter()
            e.save_snapshot(ck, extra_meta)
            save[label] = {"kind": ck.last_save_kind,
                           "bytes": ck.last_save_bytes,
                           "raw_bytes": ck.last_save_raw_bytes,
                           "ms": (time.perf_counter() - s0) * 1e3}
        res["saves"].append(save)
        return save

    # the hose is the same after a restart: the synthetic stream's draws
    # depend on every earlier tick, so draw (and drop) the ticks before
    # the resumed one, and tick t carries what an uncrashed run saw (the
    # firehose workload is pure in (seed, t): nothing to draw)
    t0 = time.perf_counter()
    for t in range(0 if pure else res["start_tick"]):
        gen_tick(t)
    res["skip_draw_ms"] = (time.perf_counter() - t0) * 1e3
    wall0 = time.perf_counter()
    for t in range(res["start_tick"], opts.ticks):
        t0 = time.perf_counter()
        ev, tw = gen_tick(t)
        rec = {"t": t, "draw_ms": (time.perf_counter() - t0) * 1e3,
               "compact_ms": 0.0, "spell_ms": 0.0, "request_ms": 0.0}
        if opts.fail_replica_at == t:
            rt_group.fail(0)
            log(f"[t={t}] replica 0 FAILED; leader is now "
                f"{rt_group.leader()}")
        if svc is not None:
            # simulated arrival pacing: ticks arrive every --tick-ms of
            # wall time; processing slower than that accrues lag the
            # controller must batch/shed away
            lag_hint = 0.0
            if opts.tick_ms > 0:
                arrived = (time.perf_counter() - wall0) * 1e3 / opts.tick_ms
                lag_hint = max(0.0, res["start_tick"] + arrived - t)
            c0 = dict(svc.overload.counters)
            l0 = dict(logged)
            t0 = time.perf_counter()
            out = svc.step(ev, tw, log_append=log_all, lag_hint=lag_hint)
            _sync(device)
            rec["steps_ms"] = (time.perf_counter() - t0) * 1e3
            c1 = svc.overload.counters
            rec["overload"] = {
                "level": svc.overload.ladder.level, "lag_hint": lag_hint,
                "backlog": len(svc.overload.batcher),
                **{k: c1[f"n_{k}"] - c0[f"n_{k}"] for k in (
                    "offered_events", "shed_events", "offered_tweets",
                    "shed_tweets")},
                "logged_events": logged["events"] - l0["events"],
                "logged_tweets": logged["tweets"] - l0["tweets"]}
            t0 = time.perf_counter()
            leader = rt_group.leader()
            ranked = out is not None and out.get("rt") is not None
            # persist on a rank cycle — and heartbeat at the same cadence
            # while ranking is shed, so frontends keep seeing fresh shed /
            # latency telemetry (and the leader keeps snapshotting state
            # for crash recovery) through a sustained overload. The
            # heartbeat re-persists the STALE table under its honest
            # ``tick`` (the last ranked tick), never claiming freshness.
            heartbeat = (not ranked and t > 0
                         and t % svc.rt.cfg.rank_every == 0)
            if (ranked or heartbeat) and leader is not None:
                done = int(svc.rt.state.tick) - 1   # stats watermark
                stats = svc.overload.stats_snapshot()
                meta = {"layout": svc.rt.cfg.cooc_layout, "overload": stats}
                if opts.plan is not None:   # tuned variants -> metrics
                    meta["plan"] = opts.plan.to_json()
                if ranked:
                    meta["tick"] = done             # last reflected tick
                elif svc.rt.last_rank_tick >= 0:
                    meta["tick"] = int(svc.rt.last_rank_tick) - 1
                if svc.rt.last_maintenance:
                    meta["maintenance"] = svc.rt.last_maintenance
                if rt_group.persist(leader, done,
                                    pack_suggestions(svc.rt.suggestions),
                                    meta):
                    save = save_states(t, svc.rt, heartbeat,
                                       {"overload": stats})
                    log(f"[t={t}] leader persisted "
                        f"{len(svc.rt.suggestions)} rows"
                        f"{' (heartbeat)' if heartbeat else ''} at level "
                        f"{svc.overload.ladder.name} (snapshots: rt="
                        f"{save['rt']['kind']}, bg={save['bg']['kind']})")
            if out is not None and out.get("bg") is not None:
                bg_ckpt.save(t, pack_suggestions(svc.bg.suggestions),
                             meta={"tick": int(svc.bg.state.tick) - 1})
            rec["persist_ms"] = (time.perf_counter() - t0) * 1e3
        else:
            t0 = time.perf_counter()
            log_all(t, ev, tw)
            results = []
            for rid, eng in enumerate(backends):
                if rt_group.alive[rid]:
                    results.append((rid, eng.step(ev, tw)))
            bg_res = bg_engine.step(ev, tw)
            _sync(device)
            rec["steps_ms"] = (time.perf_counter() - t0) * 1e3

            t0 = time.perf_counter()
            for rid, out in results:
                if out is None:
                    continue
                # a rank cycle ran -> the leader persists its table
                eng = backends[rid]
                meta = {"tick": t, "layout": eng.cfg.cooc_layout}
                if eng.last_maintenance:  # freelist pressure -> frontends
                    meta["maintenance"] = eng.last_maintenance
                if opts.plan is not None:   # tuned variants -> metrics
                    meta["plan"] = opts.plan.to_json()
                if not rt_group.persist(rid, t,
                                        pack_suggestions(eng.suggestions),
                                        meta):
                    continue
                save = save_states(t, eng, False)
                log(f"[t={t}] leader replica {rid} persisted "
                    f"{len(eng.suggestions)} suggestion rows (state "
                    f"snapshots: rt={save['rt']['kind']}/"
                    f"{save['rt']['bytes']}B, bg={save['bg']['kind']}/"
                    f"{save['bg']['bytes']}B)")
            if bg_res is not None:
                bg_ckpt.save(t, pack_suggestions(bg_engine.suggestions),
                             meta={"tick": t})
            rec["persist_ms"] = (time.perf_counter() - t0) * 1e3

        # the leader folds the sealed log into a base on cadence (bounded
        # on-disk bytes; replay-from-zero survives via the base)
        if compactor is not None and t > 0 and t % opts.compact_every == 0 \
                and rt_group.leader() is not None:
            t0 = time.perf_counter()
            writer.flush()          # seal the tail so the floor reaches t
            before = _disk_bytes(log_dir)
            compactor.assume_epoch(rt_group.epoch)
            cst = compactor.compact()
            rec["compact_ms"] = (time.perf_counter() - t0) * 1e3
            res["compactions"].append({"t": t, "stats": cst,
                                       "bytes_before": before,
                                       "bytes_after": _disk_bytes(log_dir)})
            if not cst.get("noop"):
                log(f"[t={t}] compacted: floor={cst['floor']} "
                    f"dropped {cst['n_segments_dropped']} segments "
                    f"({cst['wall_s']:.2f}s)")

        # periodic spelling job (paper: a Pig job over a long span)
        leader = rt_group.leader()
        if t > 0 and t % SPELL_EVERY == 0 and leader is not None:
            t0 = time.perf_counter()
            exp = stores.export_live(backends[leader].state.qstore)
            fps = join_fp(exp["key_hi"], exp["key_lo"])
            texts = [tok.text(int(f)) for f in fps]
            corr = spelling_cycle(fps, texts, exp["weight"], SpellConfig(),
                                  device=device)
            if corr:
                a = np.array(list(corr.keys()), np.uint64)
                b = np.array([v[0] for v in corr.values()], np.uint64)
                d = np.array([v[1] for v in corr.values()], np.float64)
                spell_ckpt.save(t, [a, b, d])
                log(f"[t={t}] spelling job: {len(corr)} corrections")
            rec["spell_ms"] = (time.perf_counter() - t0) * 1e3
            res["spelling"].append({"t": t, "sources": len(fps),
                                    "corrections": len(corr),
                                    "ms": rec["spell_ms"]})

        # frontends poll every tick (paper: every minute)
        t0 = time.perf_counter()
        for f in frontends:
            f.poll()
        rec["poll_ms"] = (time.perf_counter() - t0) * 1e3
        rec["stack_ms"] = rec["steps_ms"] + rec["poll_ms"]

        if t % REQUEST_EVERY == 0 and t >= head_t0:
            t0 = time.perf_counter()
            route = serverset.request_info(head, k=5)
            m = frontends[0].metrics()
            rec["request_ms"] = (time.perf_counter() - t0) * 1e3
            res["requests"].append({"t": t, "route": route, "metrics": m})
            line = (f"[t={t}] related('{head}') = "
                    f"{[(s, round(sc, 3)) for s, sc in route.suggestions]} "
                    f"(rt_lag={_fmt(m['rt_lag_ticks'])} "
                    f"bg_lag={_fmt(m['bg_lag_ticks'])}")
            if svc is not None:
                line += (f" | p50/p95/p99="
                         f"{_fmt(m['step_p50_ms'])}/"
                         f"{_fmt(m['step_p95_ms'])}/"
                         f"{_fmt(m['step_p99_ms'])}ms"
                         f" level={_fmt(m['shed_level_name'])}"
                         f" shed={_fmt(m['n_shed_total'])}"
                         f" [live: level={svc.overload.ladder.name}"
                         f" shed={svc.overload.stats_snapshot()['n_shed_total']}]")
            log(line + ")")
        res["ticks"].append(rec)

        if opts.crash_at == t:
            # the whole stack exits: the writer's unsealed ticks die with
            # it, and no drain (buffered-but-unflushed ticks are already in
            # the durable log, so --recover replays them bit-exact mid-shed)
            log(f"[t={t}] CRASH (simulated): relaunch with --recover "
                f"--out {opts.out}")
            res["crashed_at"] = t
            return res

    if svc is not None:
        svc.drain()
        res["overload"] = svc.overload.stats_snapshot()
        log(f"[done] overload stats: {res['overload']}")
    writer.close()
    res["final"] = serverset.request(head, k=8)
    log(f"final suggestions for head query: {res['final']}")
    return res


def run_fleet(ecfg: EngineConfig, stream_cfg: StreamConfig,
              opts: AssistOptions, device="cuda", *,
              log: Callable[[str], None] = print) -> Dict:
    """``--fleet N``: the self-healing replicated fleet over ticks
    ``[0, opts.ticks)``, the chaos knobs wired.

    ``opts.fleet`` replicas, each a whole serving stack (rt + bg,
    ``background_config(ecfg)``), under ``FleetConfig`` defaults with
    ``opts.compact_every`` and ``opts.keep_bases``; the leader is killed
    mid-segment at ``opts.kill_leader_at`` and a live follower at
    ``opts.kill_follower_at``; the head query is asked every 6 ticks from
    its onset through a ``ServerSet`` (0.25-s timeout, one retry). Returns
    ``fleet``, ``serverset``, per-tick records ``ticks`` (``t``,
    ``offer_tick``'s ``info``, ``offer_ms``: its wall, synced),
    ``requests`` (``t``, ``RouteResult``, ``ms``) and the final
    ``metrics``.
    """
    device = stores.resolve_device(device)
    gen_tick, _, _, head, head_t0 = _hose(opts, stream_cfg)
    fleet = ServingFleet(opts.out, ecfg,
                         FleetConfig(n_replicas=opts.fleet,
                                     compact_every=opts.compact_every,
                                     keep_bases=opts.keep_bases),
                         device=device)
    ss = fleet.serverset(timeout_s=0.25, max_retries=1)
    res: Dict = {"fleet": fleet, "serverset": ss, "ticks": [],
                 "requests": []}
    for t in range(opts.ticks):
        ev, tw = gen_tick(t)
        if t == opts.kill_leader_at:
            lead = fleet.leader()
            fleet.kill(lead, mid_segment=True)
            log(f"[t={t}] leader {lead} KILLED mid-segment (torn tail)")
        if t == opts.kill_follower_at:
            victim = next((r.rid for r in fleet._replicas
                           if r.status == "live"
                           and r.rid != fleet.leader()), None)
            if victim is not None:
                fleet.kill(victim)
                log(f"[t={t}] follower {victim} killed")
        t0 = time.perf_counter()
        info = fleet.offer_tick(t, ev, tw)
        _sync(device)
        res["ticks"].append({"t": t, "info": info,
                             "offer_ms": (time.perf_counter() - t0) * 1e3})
        if t % 6 == 0 and t >= head_t0:
            t0 = time.perf_counter()
            route = ss.request_info(head, k=5)
            res["requests"].append({"t": t, "route": route,
                                    "ms": (time.perf_counter() - t0) * 1e3})
            m = fleet.metrics()
            log(f"[t={t}] related('{head}') via replica {route.replica} "
                f"(tick={_fmt(route.tick)} staleness={_fmt(route.staleness)}"
                f"{' HEDGED' if route.hedged else ''}) "
                f"{len(route.suggestions)} rows | leader={m['leader']} "
                f"epoch={m['epoch']} "
                f"status={[r['status'] for r in m['replicas'].values()]}")
    m = res["metrics"] = fleet.metrics()
    log(f"[done] fleet: {ss.n_requests} requests ({ss.n_hedged} hedged), "
        f"{m['n_failovers']} failovers, {m['n_recoveries']} recoveries, "
        f"log healed {m['n_healed_ticks']} ticks "
        f"({m['n_lost_ticks']} lost), epoch {m['epoch']}, "
        f"{m['n_compactions']} compactions "
        f"(floor={_fmt(m['log_floor_tick'])})")
    return res


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--out", default="/tmp/assist")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--fleet", type=int, default=0,
                    help="run N self-healing fleet replicas instead of the "
                         "single-stack path (distributed.fleet)")
    ap.add_argument("--kill-leader-at", type=int, default=-1,
                    help="fleet chaos: kill the log-writer leader "
                         "mid-segment at this tick")
    ap.add_argument("--kill-follower-at", type=int, default=-1,
                    help="fleet chaos: kill a live follower at this tick")
    ap.add_argument("--fail-replica-at", type=int, default=-1,
                    help="tick at which backend replica 0 dies (failover demo)")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="tick at which the WHOLE stack exits mid-run "
                         "(relaunch with --recover to pick it back up)")
    ap.add_argument("--recover", action="store_true",
                    help="restore rt+bg engine state from the snapshot "
                         "chains and replay the log tail before serving")
    ap.add_argument("--full-every", type=int, default=4,
                    help="state-snapshot chain: one full every N snapshots, "
                         "deltas (changed slots only) in between")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="enable overload control with this per-tick step "
                         "latency SLO (0 = legacy per-tick path)")
    ap.add_argument("--workload", choices=("synthetic", "firehose"),
                    default="synthetic",
                    help="'firehose' = flash-crowd workload generator "
                         "(streaming/workload.py)")
    ap.add_argument("--spike-mult", type=float, default=50.0,
                    help="flash-crowd peak volume multiplier (firehose)")
    ap.add_argument("--spike-at", type=int, default=30,
                    help="flash-crowd onset tick (firehose)")
    ap.add_argument("--tick-ms", type=float, default=0.0,
                    help="simulated real-time budget per tick; processing "
                         "slower than this accrues lag (0 = no pacing)")
    ap.add_argument("--slow-io-ms", type=float, default=0.0,
                    help="inject this much latency into every log-segment "
                         "seal (chaos: degraded disk)")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="fold the sealed log into a base snapshot every N "
                         "ticks: bounded on-disk bytes, replay-from-zero "
                         "kept alive via the base (0 = no compaction)")
    ap.add_argument("--keep-bases", type=int, default=2,
                    help="compaction fallback depth: old bases (and their "
                         "log tail) retained after each floor swap")
    ap.add_argument("--autotune", action="store_true",
                    help="time the hot paths' kernels and twins at startup "
                         "(cached per device and shape class) and report "
                         "the plan in the frontends' metrics")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    return ap


def options(argv=None, plan: Optional[TunedPlan] = None) -> AssistOptions:
    """The :class:`AssistOptions` of a command line (``sys.argv`` when
    ``argv`` is None), with the tuner's ``plan`` if one was made."""
    args = _parser().parse_args(argv)
    return AssistOptions(ticks=args.ticks, out=args.out,
                         replicas=args.replicas,
                         fail_replica_at=args.fail_replica_at,
                         crash_at=args.crash_at, recover=args.recover,
                         full_every=args.full_every,
                         slow_io_ms=args.slow_io_ms, slo_ms=args.slo_ms,
                         tick_ms=args.tick_ms, workload=args.workload,
                         spike_at=args.spike_at, spike_mult=args.spike_mult,
                         compact_every=args.compact_every,
                         keep_bases=args.keep_bases, fleet=args.fleet,
                         kill_leader_at=args.kill_leader_at,
                         kill_follower_at=args.kill_follower_at, plan=plan)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    ecfg, scfg = default_configs()
    plan = None
    if args.autotune:
        from .autotune import tune
        plan = tune(ecfg, device=args.device)
        print("[assist] tuned plan:", plan.variants(), flush=True)
    opts = options(argv, plan)
    if opts.fleet > 0:
        run_fleet(ecfg, scfg, opts, args.device)
    else:
        run(ecfg, scfg, opts, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end search-assistance service launcher (paper Figure 4).

Runs the deployed architecture on a synthetic stream (the
``steve_jobs_scenario`` event): backend engine replicas consuming the
query hose + firehose, leader-elected persistence every rank cycle,
frontend replicas polling for fresh results behind a ``ServerSet``, the
background model + interpolation, and a periodic spelling job (every 60
ticks, ``edit_distance`` on the card).

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
the resumed ticks from a fresh stream, whose draws depend on every earlier
tick: its resumed tick t is not the uncrashed run's tick t.)

  python -m repro_torch.launch.serve_assist --ticks 120 --out /tmp/assist
  python -m repro_torch.launch.serve_assist --ticks 120 --out /tmp/assist --recover
  python -m repro_torch.launch.serve_assist --device cpu --ticks 61 \\
      --out /tmp/assist_t --crash-at 40

Port of the JAX package's ``launch/serve_assist.py``, its single-stack
path. The loop is :func:`run` (engine config, base stream config,
:class:`AssistOptions`, device); :func:`main` calls it with the JAX
file's own settings. Engines run on CUDA unless ``--device`` names
another device. Flags of modules not ported yet raise
``NotImplementedError`` naming their ROADMAP item: ``--fleet``,
``--kill-leader-at`` and ``--kill-follower-at`` (the fleet, item 12),
``--autotune`` (item 11), ``--slo-ms``, ``--tick-ms``, ``--workload
firehose``, ``--spike-at`` and ``--spike-mult`` (overload control and the
workload generator, item 10), ``--compact-every`` and ``--keep-bases``
(log compaction, item 8c). ``--use-kernel`` is not carried over: on CUDA
every hot path runs its kernel, and the port's ``SpellConfig`` has no
``use_kernel`` field.

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
from typing import Callable, Dict, List

import numpy as np
import torch

from ..core import stores
from ..core.background import background_config
from ..core.engine import EngineConfig, SearchAssistanceEngine, clone_state
from ..core.hashing import join_fp
from ..core.spelling import SpellConfig, spelling_cycle
from ..data.stream import StreamConfig, SyntheticStream, steve_jobs_scenario
from ..distributed.fault_tolerance import CheckpointManager, ReplicaGroup
from ..serving.serve import ServerSet, SuggestFrontend, pack_suggestions
from ..streaming import (FirehoseLogReader, FirehoseLogWriter, ReplayConfig,
                         recover_service, slow_io)

SPELL_EVERY = 60          # ticks between spelling jobs
REQUEST_EVERY = 12        # ticks between the head query's requests
TICKS_PER_SEGMENT = 8     # the durable log's segment length


@dataclasses.dataclass(frozen=True)
class AssistOptions:
    """The run's options, one per ported CLI flag (its defaults are the
    parser's)."""
    ticks: int
    out: str
    replicas: int
    fail_replica_at: int    # tick at which backend replica 0 dies (-1: never)
    crash_at: int           # tick after which the whole stack exits (-1: never)
    recover: bool           # restore rt + bg and replay the log first
    full_every: int         # snapshot chain: a full every N snapshots
    slow_io_ms: float       # latency injected into every log seal


def default_configs():
    """The JAX launcher's own settings: (engine config, base stream
    config)."""
    return (EngineConfig(query_capacity=1 << 14, cooc_capacity=1 << 17,
                         session_capacity=1 << 14, decay_every=6,
                         rank_every=12),
            StreamConfig(vocab_size=2048, queries_per_tick=1024,
                         tweets_per_tick=128))


def _fmt(v, nd: int = 1):
    """Status-line formatting: a missing signal prints as '?', not None
    (lag is None before the first log segment seals)."""
    if v is None:
        return "?"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    added to (seed 0). Returns the live stack (``backends``, ``bg``,
    ``frontends``, ``serverset``, ``tok``, ``head``), ``start_tick``,
    ``recover`` (``recover_service``'s stats and ``wall_s``, or None),
    ``crashed_at`` (or None), ``skip_draw_ms`` (the resumed run's draws
    of the ticks before its first), and per-event records: ``ticks``
    (``t``; ``draw_ms``: the tick's stream draw; ``steps_ms``: log append and engine steps, synced; ``poll_ms``: the
    frontends' polls; ``stack_ms``, their sum; ``persist_ms``;
    ``spell_ms``; ``request_ms``), ``saves`` (each engine's snapshot
    kind, bytes and ms), ``spelling`` and ``requests`` (``RouteResult``
    and the first frontend's ``metrics()``).
    """
    device = stores.resolve_device(device)
    scfg, event = steve_jobs_scenario(base_cfg=stream_cfg)
    stream = SyntheticStream(scfg, seed=0)
    tok = stream.tok
    head, head_t0 = event.terms[0], event.t_start
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
                 "ticks": [], "saves": [], "spelling": [], "requests": [],
                 "tok": tok, "head": head}

    if opts.recover:
        # recover_service handles engines with no snapshot yet (a crash
        # before the first persist): they cold-start and replay the whole
        # retained log, so resume always lands past the logged ticks.
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
    bg_ckpt = CheckpointManager(bg_dir)
    spell_ckpt = CheckpointManager(spell_dir)
    frontends = [SuggestFrontend(rt_dir, bg_dir, tok,
                                 spell_dir=spell_dir, log_dir=log_dir)
                 for _ in range(2)]
    serverset = ServerSet(frontends)
    res.update(backends=backends, bg=bg_engine, frontends=frontends,
               serverset=serverset)

    # the hose is the same after a restart: the synthetic stream's draws
    # depend on every earlier tick, so draw (and drop) the ticks before
    # the resumed one, and tick t carries what an uncrashed run saw
    t0 = time.perf_counter()
    for t in range(res["start_tick"]):
        stream.gen_tick(t)
    res["skip_draw_ms"] = (time.perf_counter() - t0) * 1e3
    for t in range(res["start_tick"], opts.ticks):
        t0 = time.perf_counter()
        ev, tw = stream.gen_tick(t)
        rec = {"t": t, "draw_ms": (time.perf_counter() - t0) * 1e3,
               "spell_ms": 0.0, "request_ms": 0.0}
        if opts.fail_replica_at == t:
            rt_group.fail(0)
            log(f"[t={t}] replica 0 FAILED; leader is now "
                f"{rt_group.leader()}")
        t0 = time.perf_counter()
        # the elected leader appends to the durable log before ingestion
        for rid in rt_group.live():
            rt_group.log_append(rid, writer, t, ev, tw)
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
            if not rt_group.persist(rid, t, pack_suggestions(eng.suggestions),
                                    meta):
                continue
            # the leader also snapshots BOTH engine states (delta-chained)
            # so a crashed stack restores rt AND bg
            save = {"t": t}
            for label, e, ck in (("rt", eng, state_rt_ckpt),
                                 ("bg", bg_engine, state_bg_ckpt)):
                s0 = time.perf_counter()
                e.save_snapshot(ck)
                save[label] = {"kind": ck.last_save_kind,
                               "bytes": ck.last_save_bytes,
                               "raw_bytes": ck.last_save_raw_bytes,
                               "ms": (time.perf_counter() - s0) * 1e3}
            res["saves"].append(save)
            log(f"[t={t}] leader replica {rid} persisted "
                f"{len(eng.suggestions)} suggestion rows (state snapshots: "
                f"rt={save['rt']['kind']}/{save['rt']['bytes']}B, "
                f"bg={save['bg']['kind']}/{save['bg']['bytes']}B)")
        if bg_res is not None:
            bg_ckpt.save(t, pack_suggestions(bg_engine.suggestions),
                         meta={"tick": t})
        rec["persist_ms"] = (time.perf_counter() - t0) * 1e3

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
            log(f"[t={t}] related('{head}') = "
                f"{[(s, round(sc, 3)) for s, sc in route.suggestions]} "
                f"(rt_lag={_fmt(m['rt_lag_ticks'])} "
                f"bg_lag={_fmt(m['bg_lag_ticks'])})")
        res["ticks"].append(rec)

        if opts.crash_at == t:
            # the whole stack exits: the writer's unsealed ticks die with it
            log(f"[t={t}] CRASH (simulated): relaunch with --recover "
                f"--out {opts.out}")
            res["crashed_at"] = t
            return res

    writer.close()
    res["final"] = serverset.request(head, k=8)
    log(f"final suggestions for head query: {res['final']}")
    return res


# Flags of the JAX launcher whose modules are not ported yet: dest, flag,
# what it needs.
_UNPORTED = (
    ("fleet", "--fleet", "ROADMAP Queue 1 item 12 (distributed/fleet.py)"),
    ("kill_leader_at", "--kill-leader-at",
     "ROADMAP Queue 1 item 12 (distributed/fleet.py)"),
    ("kill_follower_at", "--kill-follower-at",
     "ROADMAP Queue 1 item 12 (distributed/fleet.py)"),
    ("autotune", "--autotune", "ROADMAP Queue 1 item 11 (launch/autotune.py)"),
    ("slo_ms", "--slo-ms", "ROADMAP Queue 1 item 10 (streaming/overload.py)"),
    ("tick_ms", "--tick-ms",
     "ROADMAP Queue 1 item 10 (streaming/overload.py)"),
    ("workload", "--workload firehose",
     "ROADMAP Queue 1 item 10 (streaming/workload.py)"),
    ("spike_at", "--spike-at",
     "ROADMAP Queue 1 item 10 (streaming/workload.py)"),
    ("spike_mult", "--spike-mult",
     "ROADMAP Queue 1 item 10 (streaming/workload.py)"),
    ("compact_every", "--compact-every",
     "ROADMAP Queue 1 item 8c (streaming/compaction.py)"),
    ("keep_bases", "--keep-bases",
     "ROADMAP Queue 1 item 8c (streaming/compaction.py)"),
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--out", default="/tmp/assist")
    ap.add_argument("--replicas", type=int, default=2)
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
    ap.add_argument("--slow-io-ms", type=float, default=0.0,
                    help="inject this much latency into every log-segment "
                         "seal (chaos: degraded disk)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    not_ported = "not ported yet: raises NotImplementedError"
    ap.add_argument("--fleet", type=int, default=0, help=not_ported)
    ap.add_argument("--kill-leader-at", type=int, default=-1, help=not_ported)
    ap.add_argument("--kill-follower-at", type=int, default=-1,
                    help=not_ported)
    ap.add_argument("--autotune", action="store_true", help=not_ported)
    ap.add_argument("--slo-ms", type=float, default=0.0, help=not_ported)
    ap.add_argument("--workload", choices=("synthetic", "firehose"),
                    default="synthetic",
                    help="'firehose' is " + not_ported)
    ap.add_argument("--spike-mult", type=float, default=50.0,
                    help=not_ported)
    ap.add_argument("--spike-at", type=int, default=30, help=not_ported)
    ap.add_argument("--tick-ms", type=float, default=0.0, help=not_ported)
    ap.add_argument("--compact-every", type=int, default=0, help=not_ported)
    ap.add_argument("--keep-bases", type=int, default=2, help=not_ported)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    for dest, flag, needs in _UNPORTED:
        if getattr(args, dest) != ap.get_default(dest):
            raise NotImplementedError(
                f"{flag} is not ported to repro_torch yet: it needs {needs}")
    ecfg, scfg = default_configs()
    opts = AssistOptions(ticks=args.ticks, out=args.out,
                         replicas=args.replicas,
                         fail_replica_at=args.fail_replica_at,
                         crash_at=args.crash_at, recover=args.recover,
                         full_every=args.full_every,
                         slow_io_ms=args.slow_io_ms)
    run(ecfg, scfg, opts, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

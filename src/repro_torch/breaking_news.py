"""The paper's Figure-1 scenario end to end, on the PyTorch port: a
breaking-news event ("steve jobs") spikes in the stream; the query-share
curve is printed as text, with the time until the engine surfaces the
related suggestions against the paper's 10-minute target.

Mid-event the engine CRASHES (§4.2's failure case: the stores live in
device memory and die with the process, and the crash tears the segment
the log writer was buffering). Recovery restores the newest snapshot and
replays the durable firehose log faster than real time; the suggestions,
the breaking-news terms that surfaced before the crash included, survive.

  PYTHONPATH=src python -m repro_torch.breaking_news              # on the GPU
  PYTHONPATH=src python -m repro_torch.breaking_news --device cpu

Port of the JAX package's ``examples/breaking_news.py``: same scenario,
configuration and crash point. Exits non-zero when the related terms never
surface or are lost across the crash.
"""
import argparse
import os
import sys
import tempfile
from typing import Callable, Dict, Optional

from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.data.stream import (StreamConfig, SyntheticStream,
                                     steve_jobs_scenario)
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.streaming import (FirehoseLogWriter, ReplayConfig,
                                   kill_writer_mid_segment, recover_engine)

STREAM = StreamConfig(vocab_size=1024, queries_per_tick=2048,
                      tweets_per_tick=128, tick_seconds=30.0)
# rank every 10 ticks: every 5 simulated minutes
ENGINE = EngineConfig(query_capacity=1 << 14, cooc_capacity=1 << 17,
                      session_capacity=1 << 14, decay_every=4, rank_every=10)
TARGET_MIN = 10.0                     # the paper's freshness target
CRASH_AFTER_START = 17                # mid-event, mid-segment
TICKS_AFTER_START = 40


def run(device="cuda", stream_cfg: StreamConfig = STREAM,
        cfg: EngineConfig = ENGINE, out_dir: Optional[str] = None,
        log: Callable[[str], None] = print) -> Dict:
    """Drive the scenario on ``device``, crash mid-event, recover, go on.

    Returns ``first_hit_tick``, ``latency_min`` (sim-minutes from the
    event's start until a related term surfaced, or None), ``recovery``
    (the replay stats), ``kept`` (event terms suggested before and after
    the crash) and ``final`` (the head query's suggestions at the end).
    """
    scfg, event = steve_jobs_scenario(base_cfg=stream_cfg)
    stream = SyntheticStream(scfg, seed=0)
    engine = SearchAssistanceEngine(cfg, device=device)
    head = stream.tok.query_fp(event.terms[0])
    related = {stream.tok.query_fp(t): t for t in event.terms[1:]}

    out = out_dir or tempfile.mkdtemp(prefix="breaking_news_")
    ckpt = CheckpointManager(os.path.join(out, "ckpt"), keep_n=3)
    log_dir = os.path.join(out, "log")
    writer = FirehoseLogWriter(log_dir, ticks_per_segment=5)
    crash_at = event.t_start + CRASH_AFTER_START
    tick_min = scfg.tick_seconds / 60

    log(f"event {event.name!r} breaks at tick {event.t_start} "
        f"({event.t_start * tick_min:.0f} sim-min); engine will crash at "
        f"tick {crash_at}\n")
    res: Dict = {"first_hit_tick": None, "latency_min": None,
                 "recovery": None, "kept": []}
    for t in range(event.t_start + TICKS_AFTER_START):
        events, tweets = stream.gen_tick(t)
        if t == crash_at:
            # the crash kills the process: device stores gone, the log's
            # buffered segment torn. Restore the newest snapshot and replay
            # the log tail faster than real time.
            kill_writer_mid_segment(writer)
            pre_crash = {d for d, _ in engine.suggest_fp(head, k=8)}
            del engine
            engine, stats = recover_engine(cfg, ckpt, log_dir,
                                           ReplayConfig(chunk_ticks=5),
                                           device=device)
            post = {d for d, _ in engine.suggest_fp(head, k=8)}
            res["kept"] = sorted(related[d] for d in pre_crash & post
                                 if d in related)
            wall = stats["restore_s"] + stats["wall_s"]
            res["recovery"] = dict(stats, wall_total_s=wall)
            log(f"\n*** t={t}: CRASH + recovery — restored snapshot tick "
                f"{stats['restored_step']}, replayed {stats['n_ticks']} "
                f"ticks in {wall:.3f}s wall (restore {stats['restore_s']:.3f}"
                f"s, replay and handoff {stats['wall_s']:.3f}s; "
                f"{stats['n_ticks'] * scfg.tick_seconds / max(wall, 1e-9):.0f}"
                f"x real time); surviving event suggestions: {res['kept']}\n")
            # the restarted process appends to the same log; its offsets go
            # on from where replay ended (the torn ticks are lost, §4.2:
            # "losing a little bit of state is tolerable")
            writer = FirehoseLogWriter(log_dir, ticks_per_segment=5)
        # the engine's own tick is the log offset space (they coincide
        # until the crash drops the torn ticks)
        writer.append(int(engine.state.tick), events, tweets)
        if engine.step(events, tweets) is not None:
            engine.save_snapshot(ckpt)      # persist every rank cycle
        share = stream.event_share(t)[0]
        if t % 2 == 0:
            log(f"t={t:3d} share={share:5.3f} {'#' * int(share * 200)}")
        if res["first_hit_tick"] is None and engine.suggestions:
            hits = [related[d] for d, _ in engine.suggest_fp(head, k=8)
                    if d in related]
            if hits:
                res["first_hit_tick"] = t
                res["latency_min"] = (t - event.t_start) * tick_min
                log(f"\n>>> t={t}: related({event.terms[0]!r}) now contains "
                    f"{hits} — {res['latency_min']:.1f} sim-min after the "
                    f"event (paper target: <= {TARGET_MIN:.0f} min)\n")
    res["final"] = [(stream.tok.text(d), round(s, 3))
                    for d, s in engine.suggest_fp(head, k=8)]
    res["event_terms"] = list(event.terms[1:])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    res = run(args.device)
    if res["first_hit_tick"] is None:
        print("suggestion never surfaced")
        return 1
    print("final suggestions (crash survived):", res["final"])
    if not any(term in dict(res["final"]) for term in res["event_terms"]):
        print("event suggestions lost across the crash")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

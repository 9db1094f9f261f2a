"""Catch-up replay: restore a snapshot, rewind into the log, outrun time.

The PyTorch port of the JAX package's ``streaming/replay.py``. The engine's
``ingest_many`` is a loop over ticks here (one ``lax.scan`` dispatch per
chunk in JAX); each tick runs exactly what a live ``step()`` does, so the
replayed state is bit for bit the uncrashed engine's. Not ported yet:
``recover_service`` (it needs ``core/background.py``) and the log
compaction tier: a log whose manifest advertises a compaction base is
refused (``NotImplementedError``), since replaying it without the base
would be a different result.

Paper §4.2: "since the stores are memory-resident, their contents do not
survive restarts ... a (re)started instance can rewind to an earlier point
in the hose and consume messages at a faster rate than real time to catch
up to the present; in the meantime, the frontends serve the most recently
persisted results". This module is that loop:

  1. **restore** the newest ``EngineState`` snapshot — a
     ``CheckpointManager`` checkpoint whose manifest records the log offset
     (``log_tick``) replay must resume from;
  2. **replay** the firehose-log tail *faster than real time*: chunks of
     stacked micro-batches go through ``engine.step_many``. Replay-mode
     overrides: ranking cycles are suppressed while the lag to the log
     head is >= ``rank_lag_ticks`` (the frontend is serving stale tables
     anyway), while the decay/prune maintenance keeps its exact live
     cadence in every replayed tick (state equality depends on it);
  3. **hand off** to live ingestion once caught up (and run the rank cycle
     the live engine would have been due for).

Replayed state is bit-for-bit identical to an uninterrupted run (tested at
every segment boundary), exact under the lazy/exponential decay policy.

**Snapshot chains + fallback** (``distributed.fault_tolerance``): a
snapshot step may be a *delta* (changed slots only) chained to the last
full snapshot via its manifest (``kind``/``base_step``/``sha256``). The
restore chain-walk verifies every member; a torn or corrupt delta falls
back to the newest intact full — recovery then simply resumes replay from
that older snapshot's ``log_tick``, i.e. a broken chain costs a longer
replay tail, never a failed recovery (as long as one full verifies and the
log retains the tail). ``stats["restore"]`` records the fallback.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.engine import EngineConfig, SearchAssistanceEngine, TickStack
from ..core.hashing import from_np_u32, split_fp
from ..core.stores import resolve_device
from ..distributed.fault_tolerance import CheckpointManager
from .log import FirehoseLogReader, LogChunk


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    chunk_ticks: int = 16       # ticks read and stacked at a time
    rank_lag_ticks: int = 4     # resume ranking once lag drops below this
    allow_gap: bool = False     # snapshot older than log retention: skip
                                # to the log start (documented state loss)
                                # instead of raising


def chunk_to_stack(chunk: LogChunk, device="cuda") -> TickStack:
    """Host log chunk -> TickStack on ``device`` (CUDA unless named; u64
    fps split into u32 lanes, held as int32 bit views)."""
    device = resolve_device(device)
    u32 = lambda fp: [from_np_u32(x, device) for x in split_fp(fp)]
    s_hi, s_lo = u32(chunk.sess_fp)
    q_hi, q_lo = u32(chunk.q_fp)
    g_hi, g_lo = u32(chunk.grams)
    return TickStack(
        sess_hi=s_hi, sess_lo=s_lo, q_hi=q_hi, q_lo=q_lo,
        src=torch.tensor(np.asarray(chunk.src, np.int32), device=device),
        q_valid=torch.tensor(np.asarray(chunk.q_valid, bool), device=device),
        g_hi=g_hi, g_lo=g_lo,
        t_valid=torch.tensor(np.asarray(chunk.t_valid, bool), device=device))


def _set_tick(eng: SearchAssistanceEngine, tick: int) -> None:
    eng.state = eng.state._replace(tick=torch.tensor(
        tick, dtype=torch.int32, device=eng.device))


class CatchUpController:
    """Drives one engine from its restored offset to the log head."""

    def __init__(self, engine: SearchAssistanceEngine,
                 reader: FirehoseLogReader,
                 rcfg: ReplayConfig = ReplayConfig()):
        self.engine = engine
        self.reader = reader
        self.rcfg = rcfg

    def catch_up(self, target_tick: Optional[int] = None,
                 refresh: bool = True) -> Dict:
        """Replay [engine.tick, target) from the log; default target is one
        past the log head. Returns replay stats (ticks, chunks, wall time
        and the rank cycles' share of it, suppressed/run rank cycles,
        events replayed). ``refresh=False``
        skips re-validating the log (pass it when the reader was freshly
        constructed — its ``__init__`` already checksummed every segment,
        and doing it twice doubles the restart-critical disk pass)."""
        eng, rcfg = self.engine, self.rcfg
        if refresh:
            self.reader.refresh()
        start = int(eng.state.tick)
        head = self.reader.last_tick()
        end = target_tick if target_tick is not None else (
            head + 1 if head is not None else start)
        stats = {"start_tick": start, "end_tick": end, "n_ticks": 0,
                 "n_chunks": 0, "n_events": 0, "n_rank_suppressed": 0,
                 "n_rank_run": 0, "n_skipped_gap_ticks": 0, "wall_s": 0.0,
                 "rank_s": 0.0}
        t0 = time.perf_counter()
        rank_every = eng.cfg.rank_every
        if end > start:
            first = self.reader.first_tick()
            if first is not None and first > start:
                if not rcfg.allow_gap:
                    raise ValueError(
                        f"snapshot at tick {start} predates log retention "
                        f"(log starts at {first}); pass allow_gap to skip "
                        f"ahead")
                stats["n_skipped_gap_ticks"] = first - start
                _set_tick(eng, first)
                start = first
            for chunk in self.reader.read_chunks(start, rcfg.chunk_ticks,
                                                 upto_tick=end):
                # a chunk is normally one consecutive run; tick holes (a
                # crash tore ticks a newer snapshot had covered, or the
                # writer skipped ticks) split it into runs, each replayed
                # after an allow_gap fast-forward — skipping is safe-but-
                # lossy (§4.2: losing a little state is tolerable)
                tks = chunk.ticks
                breaks = np.nonzero(tks[1:] - tks[:-1] != 1)[0] + 1
                n_due = 0
                for run in np.split(np.arange(tks.shape[0]), breaks):
                    sub = (chunk if len(run) == tks.shape[0]
                           else LogChunk(*(a[run] for a in chunk)))
                    expect = int(eng.state.tick)
                    gap = int(sub.ticks[0]) - expect
                    if gap < 0 or (gap > 0 and not rcfg.allow_gap):
                        raise ValueError(
                            f"log gap: replay expected tick {expect}, run "
                            f"covers [{int(sub.ticks[0])}, "
                            f"{int(sub.ticks[-1])}]"
                            + ("" if gap < 0 else "; pass allow_gap to "
                               "skip the missing ticks"))
                    if gap > 0:
                        stats["n_skipped_gap_ticks"] += gap
                        _set_tick(eng, int(sub.ticks[0]))
                    eng.step_many(chunk_to_stack(sub, eng.device))
                    stats["n_ticks"] += sub.n_ticks
                    stats["n_events"] += int(sub.q_valid.sum()) \
                        + int(sub.t_valid.sum())
                    # rank boundaries crossed (tick t ranks after ingesting
                    # t, i.e. t in [run.first, run.last])
                    n_due += sum(
                        1 for t in range(int(sub.ticks[0]),
                                         int(sub.ticks[-1]) + 1)
                        if rank_every > 0 and t > 0
                        and t % rank_every == 0)
                stats["n_chunks"] += 1
                if rank_every > 0:
                    lag = end - int(eng.state.tick)
                    if lag >= rcfg.rank_lag_ticks:
                        stats["n_rank_suppressed"] += n_due
                    elif n_due:
                        # caught up enough: serve fresh tables from here on
                        self._rank(stats)
                        stats["n_rank_suppressed"] += n_due - 1
        # handoff: if no cycle ran at the head, run one now so the frontend
        # gets fresh tables immediately (rank cycles read state, never
        # mutate it — running extra ones cannot break replay exactness).
        # This must also cover the 0-tick replay case: a snapshot can be
        # newer than the log's surviving tail (the torn segment held the
        # ticks between them) and the restored stores still deserve tables;
        # repeated catch-up calls on an already-fresh engine stay no-ops.
        if rank_every > 0 and stats["n_rank_run"] == 0 \
                and (stats["n_ticks"] > 0 or not eng.suggestions):
            self._rank(stats)
        stats["wall_s"] = time.perf_counter() - t0
        return stats

    def _rank(self, stats: Dict) -> None:
        """One rank cycle; ``stats["rank_s"]`` sums their wall time, so
        ``wall_s - rank_s`` is the replay alone."""
        t0 = time.perf_counter()
        self.engine.run_rank_cycle()
        stats["rank_s"] += time.perf_counter() - t0
        stats["n_rank_run"] += 1


def _check_snapshot_layout(cfg: EngineConfig, ckpt: CheckpointManager,
                           step: Optional[int]) -> None:
    try:
        meta = ckpt.manifest(step).get("meta", {})
    except FileNotFoundError:
        raise                      # no checkpoints at all: fail loudly
    except (OSError, json.JSONDecodeError):
        # torn/garbled manifest: leave it to the restore chain walk, which
        # falls back to the newest intact full instead of failing here
        return
    snap_layout = meta.get("layout")
    if snap_layout is not None and snap_layout != cfg.cooc_layout:
        raise ValueError(
            f"snapshot was written under cooc_layout={snap_layout!r} but "
            f"the restoring config uses {cfg.cooc_layout!r}; region "
            f"metadata (chain directory, fills, freelist) is part of the "
            f"checkpoint and cannot be reinterpreted")


def _maybe_restore_base(engine: SearchAssistanceEngine,
                        reader: FirehoseLogReader,
                        target_tick: Optional[int]) -> Optional[Dict]:
    """Where the JAX package hops onto a compaction base the log manifest
    advertises before replaying. The port has no compaction tier yet, and
    replaying such a log without its base would be a different result, so
    a log that advertises one is refused. Without bases: None."""
    if not reader.bases:
        return None
    raise NotImplementedError(
        f"log {reader.name!r} in {reader.dir} advertises compaction bases "
        f"(ticks {[int(b['tick']) for b in reader.bases]}); log compaction "
        f"is not ported to repro_torch yet")


def recover_engine(cfg: EngineConfig, ckpt: CheckpointManager, log_dir: str,
                   rcfg: ReplayConfig = ReplayConfig(), name: str = "rt",
                   log_name: str = "firehose",
                   target_tick: Optional[int] = None,
                   step: Optional[int] = None, device=None) -> tuple:
    """The full crash-recovery path: snapshot restore + catch-up replay, on
    ``device`` (CUDA unless named).

    Returns ``(engine, stats)``; the engine is caught up to the log head
    (or ``target_tick``) and ready for live ingestion, its handoff rank
    cycle run. ``step`` picks a specific snapshot (default: the newest).
    The restore walks the snapshot's delta chain; a torn/corrupt chain
    member falls back to the newest intact full snapshot
    (``stats["restore"]``) and the replay tail grows to cover the
    difference. ``stats["restore_ms"]`` is the restore's cost split.
    """
    _check_snapshot_layout(cfg, ckpt, step)
    t0 = time.perf_counter()
    engine, log_tick = SearchAssistanceEngine.restore_from_snapshot(
        cfg, ckpt, step=step, name=name, device=device)
    restore_s = time.perf_counter() - t0
    if int(engine.state.tick) != log_tick:
        raise ValueError(f"snapshot offset mismatch: state at tick "
                         f"{int(engine.state.tick)}, log_tick {log_tick}")
    reader = FirehoseLogReader(log_dir, name=log_name)
    restore_info = dict(ckpt.last_restore)
    base_info = _maybe_restore_base(engine, reader, target_tick)
    stats = CatchUpController(engine, reader, rcfg).catch_up(target_tick,
                                                             refresh=False)
    stats["restored_step"] = log_tick
    stats["restore"] = restore_info
    stats["restore_s"] = restore_s
    stats["restore_ms"] = dict(ckpt.last_restore_ms)
    stats["base"] = base_info
    return engine, stats

"""Log compaction: fold the firehose-log tail into base snapshots.

The paper keeps the entire working state in memory and treats the
persisted stream as the source of truth for rebuilds (§4.2) — which only
works if the stream stays replayable. Raw keep-N retention breaks that:
the moment the writer trims a segment, "replay from zero" dies, and
without trimming, storage grows linearly with uptime. Kafka-style log
compaction closes the gap: periodically **fold** the retained log prefix
into a new *base* snapshot (engine state reflecting every tick below some
floor, produced by the exact same ``step_many`` replay the recovery path
uses), advertise it in the log manifest, and swap retention to
``[base, head]``. Replay-from-zero then means "restore the newest base ≤
your target, replay the short tail" — possible forever, with on-disk
bytes bounded by the working-set size instead of uptime.

Layout — bases live INSIDE the log directory, one ``CheckpointManager``
snapshot chain per engine consuming the log::

    <log_dir>/firehose-compact/<engine_name>/step_<tick>/...

so "the log" (segments + manifest + bases) remains one self-contained
replayable unit: copy the directory, get a restorable service.

Contract:

  * **who compacts**: the leader only — the compactor is epoch-fenced
    exactly like the writer. ``assume_epoch`` rejects rewinds; every
    ``compact()`` re-reads the manifest epoch before folding AND again
    immediately before the manifest swap, so a zombie compactor (deposed
    mid-fold) raises :class:`WriterFencedError` without touching the
    manifest. Base snapshots a zombie managed to write before losing the
    race are inert orphans — never advertised, eventually removed by the
    next legitimate compaction's ``CheckpointManager`` retention.
  * **crash safety**: base snapshots go through ``CheckpointManager``
    (tmp dir + fsync + rename), the manifest swap through the same
    tmp + fsync + rename as the writer. A crash before the swap leaves
    orphan snapshot dirs and the old manifest — readers see the old floor,
    and a torn base fails its sha256 during restore and falls back. A
    crash after the swap but before old-segment unlink leaves unmanifested
    segment files, counted by ``FirehoseLogReader.refresh()`` and removed
    by ``repair()``.
  * **fallback**: ``keep_bases`` bases are retained, and segment
    retention keeps everything from the OLDEST retained base onward —
    so a corrupt newest base (``corrupt_base`` injection, torn write)
    degrades to "restore the previous base + replay a longer tail",
    counted in ``info['fell_back']``, never a dead log.
  * **exactness**: the fold replays with the engine's own cadence
    authority through ``engine.step_many`` and runs NO rank cycles — rank
    cycles read state, never mutate it, so the folded state is bit for bit
    what an uninterrupted engine held at the floor tick (tested at every
    compaction boundary).

Port of the JAX package's ``streaming/compaction.py``, in its on-disk
formats: a base either package writes restores into the other. The log's
name is ``log.LOG_NAME`` (no ``name``/``log_name`` option, as elsewhere in
the port) and ``CompactionConfig`` has no ``codec`` field (bases compress
through ``CheckpointManager``'s own codec). The fold
engines live on ``device`` (CUDA unless named), so the fold's replay runs
the engine's kernels on the card; restores land on the template's device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

from ..core.engine import (EngineConfig, EngineState, SearchAssistanceEngine,
                           restore_state)
from ..core.stores import resolve_device
from ..distributed.fault_tolerance import CheckpointManager, corrupt_snapshot
from .log import (LOG_NAME, FirehoseLogReader, Segment, WriterFencedError,
                  _load_manifest_doc, _manifest_path, newest_base_tick)
from .replay import chunk_to_stack


def base_dir(log_dir: str, engine_name: str) -> str:
    """Where one engine's base-snapshot chain lives (inside the log dir)."""
    return os.path.join(log_dir, f"{LOG_NAME}-compact", engine_name)


def base_manager(log_dir: str, engine_name: str,
                 keep_bases: int = 2) -> CheckpointManager:
    """The ``CheckpointManager`` over one engine's bases. ``full_interval``
    is pinned to 1: a base must restore standalone (it IS the floor — a
    delta chain would re-introduce the torn-chain replay dependency that
    compaction exists to bound)."""
    return CheckpointManager(base_dir(log_dir, engine_name),
                             keep_n=keep_bases, full_interval=1)


@dataclasses.dataclass(frozen=True)
class CompactionConfig:
    keep_bases: int = 2        # fallback depth: old bases (and their log
                               # tail) retained after a swap
    chunk_ticks: int = 16      # ticks a fold replays per step_many


class LogCompactor:
    """Folds the sealed log prefix into per-engine base snapshots and
    atomically advances the manifest's replay floor.

    One compactor instance serves every engine consuming the log (the
    rt + bg serving stack): a base entry is only advertised once ALL
    engines' folds at that floor are durably written, so the floor never
    splits across engines. Fold engines are made on ``device``: CUDA unless
    the caller names another, raising where CUDA is asked for and absent.
    """

    def __init__(self, log_dir: str, engines: Dict[str, EngineConfig], *,
                 epoch: int = 0, cfg: CompactionConfig = CompactionConfig(),
                 device=None):
        if not engines:
            raise ValueError("compactor needs at least one engine config")
        self.device = resolve_device(device)
        self.dir = log_dir
        self.engines = dict(engines)
        self.cfg = cfg
        self.epoch = int(epoch)
        self._dead = False
        self.ckpts = {e: base_manager(log_dir, e, cfg.keep_bases)
                      for e in self.engines}
        # observability
        self.n_compactions = 0
        self.n_noop = 0
        self.n_base_fallbacks = 0     # folds that started from an older
                                      # base (newest was torn/corrupt)
        self.last_stats: Dict[str, Any] = {}

    # -- fencing ----------------------------------------------------------
    def assume_epoch(self, epoch: int) -> "LogCompactor":
        """Adopt leadership ``epoch``. Rejects rewinds against the on-disk
        manifest, like ``FirehoseLogWriter.assume_epoch`` — but does NOT
        bump the manifest itself: the writer owns the epoch stamp; the
        compactor only ever swaps a manifest it re-validated under it."""
        cur = int(_load_manifest_doc(self.dir, LOG_NAME).get("epoch", 0))
        if int(epoch) < cur:
            raise WriterFencedError(
                f"compactor cannot assume epoch {epoch}: manifest already "
                f"at {cur}")
        self.epoch = int(epoch)
        self._dead = False
        return self

    def _check_fence(self) -> Dict:
        doc = _load_manifest_doc(self.dir, LOG_NAME)
        if int(doc.get("epoch", 0)) > self.epoch:
            self._dead = True
            raise WriterFencedError(
                f"compactor (epoch {self.epoch}) fenced by manifest epoch "
                f"{doc.get('epoch')}: a newer leader owns log "
                f"'{LOG_NAME}'")
        return doc

    # -- fold -------------------------------------------------------------
    def _fold_engine(self, ename: str, reader: FirehoseLogReader,
                     upto: int) -> Tuple[int, Dict]:
        """Replay engine ``ename`` to state covering every tick < upto,
        starting from its newest intact base (or cold from zero), and save
        the result as a new base snapshot step. Returns (saved step,
        per-engine stats: the JAX package's ``start``, ``n_ticks``,
        ``fell_back``, ``base_bytes``, plus ``base_raw_bytes`` and the
        seconds of the restore, the replay and the save)."""
        cfg = self.engines[ename]
        ckpt = self.ckpts[ename]
        t0 = time.perf_counter()
        eng = SearchAssistanceEngine(cfg, ename, self.device)
        start, fell_back = 0, False
        prior = [s for s in ckpt.steps() if s <= upto]
        if prior:
            # restore's chain walk verifies sha256 and falls back to the
            # newest intact base <= the request on its own — a corrupt
            # newest base costs a longer fold replay, never a failed fold
            eng.state, got = restore_state(ckpt, eng.state, prior[-1])
            start = got
            fell_back = bool(ckpt.last_restore.get("fell_back")) \
                or got < prior[-1]
        if fell_back:
            self.n_base_fallbacks += 1
        t1 = time.perf_counter()      # the restore ends with a device sync
        n_ticks = 0
        for chunk in reader.read_chunks(start, self.cfg.chunk_ticks,
                                        upto_tick=upto):
            expect = int(eng.state.tick)
            if int(chunk.ticks[0]) != expect:
                # the fold NEVER skips: a base must cover exactly
                # [0, upto) or the floor would silently lose ticks
                raise ValueError(
                    f"compaction fold gap for engine '{ename}': expected "
                    f"tick {expect}, log chunk starts at "
                    f"{int(chunk.ticks[0])}")
            eng.step_many(chunk_to_stack(chunk, self.device))
            n_ticks += chunk.n_ticks
        if int(eng.state.tick) != upto:
            raise ValueError(
                f"compaction fold for engine '{ename}' stopped at tick "
                f"{int(eng.state.tick)}, wanted {upto} (log hole below "
                f"the proposed floor)")
        t2 = time.perf_counter()      # reading the tick synced the device
        eng.save_snapshot(ckpt, extra_meta={"kind": "compaction-base",
                                            "floor_tick": upto})
        return upto, {"start": start, "n_ticks": n_ticks,
                      "fell_back": fell_back,
                      "base_bytes": ckpt.last_save_bytes,
                      "base_raw_bytes": ckpt.last_save_raw_bytes,
                      "restore_s": t1 - t0, "replay_s": t2 - t1,
                      "save_s": time.perf_counter() - t2}

    # -- the compaction cycle ---------------------------------------------
    def compact(self, upto_tick: Optional[int] = None) -> Dict:
        """One compaction cycle: fold → advertise → trim. Returns stats.

        ``upto_tick`` proposes the new floor (exclusive fold bound);
        default is one past the newest SEALED tick — the buffered tail a
        live writer holds is never folded. No-ops (with a counted stat)
        when the floor would not advance.
        """
        if self._dead:
            raise WriterFencedError("compactor was fenced; re-assume_epoch")
        t0 = time.perf_counter()
        # fold phase reads only sealed, verified segments
        reader = FirehoseLogReader(self.dir)
        self._check_fence()
        head = reader.last_tick()
        floor = newest_base_tick(reader.bases)
        upto = (head + 1 if head is not None else 0) \
            if upto_tick is None else int(upto_tick)
        if head is None or upto > head + 1:
            upto = head + 1 if head is not None else 0
        if upto <= 0 or (floor is not None and upto <= floor):
            self.n_noop += 1
            self.last_stats = {"noop": True, "floor": floor, "upto": upto}
            return self.last_stats
        # ---- fold every engine to the proposed floor (crash here: orphan
        # snapshot steps, manifest untouched) ----
        per_engine: Dict[str, Dict] = {}
        steps: Dict[str, int] = {}
        for ename in sorted(self.engines):
            step, st = self._fold_engine(ename, reader, upto)
            steps[ename] = step
            per_engine[ename] = st
        # ---- swap: re-validate fence, advertise the base, trim retention
        # to [oldest retained base, head] (atomic manifest rename) ----
        doc = self._check_fence()
        segments = [Segment(**s) for s in doc.get("segments", [])]
        bases = list(doc.get("bases", []))
        bases.append({"tick": upto, "epoch": self.epoch, "engines": steps,
                      "time": time.time()})
        bases.sort(key=lambda b: int(b["tick"]))
        if self.cfg.keep_bases > 0:
            bases = bases[-self.cfg.keep_bases:]
        # segments holding any tick >= the OLDEST retained base stay: they
        # are the fallback replay tail if a newer base turns out torn
        retain_floor = min(int(b["tick"]) for b in bases)
        keep = [s for s in segments if s.last >= retain_floor]
        drop = [s for s in segments if s.last < retain_floor]
        out = {"name": doc.get("name", LOG_NAME),
               "version": doc.get("version", 1),
               "epoch": int(doc.get("epoch", 0)),
               "segments": [dataclasses.asdict(s) for s in keep],
               "bases": bases}
        fd, tmp = tempfile.mkstemp(dir=self.dir,
                                   prefix=f".tmp_{LOG_NAME}_man_")
        with os.fdopen(fd, "w") as f:
            json.dump(out, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, _manifest_path(self.dir, LOG_NAME))
        # ---- old segment files leave disk only after the manifest stopped
        # listing them (crash between: unmanifested debris, repair()-able)
        n_unlinked = 0
        for seg in drop:
            try:
                os.unlink(os.path.join(self.dir, seg.file))
                n_unlinked += 1
            except OSError:
                pass
        self.n_compactions += 1
        self.last_stats = {
            "noop": False, "floor": upto, "prev_floor": floor,
            "retain_floor": retain_floor, "n_bases": len(bases),
            "n_segments_dropped": len(drop), "n_unlinked": n_unlinked,
            "engines": per_engine,
            "wall_s": time.perf_counter() - t0,
        }
        return self.last_stats


# ---------------------------------------------------------------------------
# Tiered restore: the read side of the bases
# ---------------------------------------------------------------------------

def restore_from_base(log_dir: str, engine_name: str, template: EngineState,
                      max_tick: Optional[int] = None
                      ) -> Optional[Tuple[EngineState, int, Dict]]:
    """Restore engine state from the newest advertised base ≤ ``max_tick``,
    shaped, typed and placed like ``template``.

    Returns ``(state, base_tick, info)`` or None when no usable base is
    advertised (no bases, none ≤ max_tick for this engine, or every
    candidate's snapshot is torn — the caller then replays from its own
    snapshot/zero as before). A torn newest base falls back THROUGH the
    manager's chain walk to the previous retained base, counted in
    ``info['fell_back']``; the returned ``base_tick`` is always the tick
    the restored state actually covers (replay resumes there).
    """
    reader = FirehoseLogReader(log_dir, verify=False)
    cands = [b for b in reader.bases
             if (max_tick is None or int(b["tick"]) <= int(max_tick))
             and engine_name in b.get("engines", {})]
    if not cands:
        return None
    cands.sort(key=lambda b: int(b["tick"]))
    requested = int(cands[-1]["tick"])
    ckpt = base_manager(log_dir, engine_name)
    advertised = {int(b["engines"][engine_name]): int(b["tick"])
                  for b in cands}
    for want in reversed(cands):
        try:
            state, got = restore_state(ckpt, template,
                                       int(want["engines"][engine_name]))
        except FileNotFoundError:
            continue               # torn + nothing older intact: next entry
        except ValueError:
            return None            # layout/template mismatch — structural
        if got in advertised:
            tick = advertised[got]
            return state, tick, {"requested": requested, "restored": tick,
                                 "fell_back": tick != requested}
        # the chain walk landed on a step no base entry advertises (a
        # zombie's orphan): don't trust its offset, try the next older
        # advertised base explicitly
    return None


def corrupt_base(log_dir: str, engine_name: str, tick: Optional[int] = None,
                 keep_fraction: float = 0.5) -> int:
    """Failure injection: tear the compressed base blob for ``engine_name``
    at the base advertised for ``tick`` (default: the newest). Restore must
    fall back to the previous retained base + a longer replay. Returns the
    snapshot step that was torn."""
    bases = FirehoseLogReader(log_dir, verify=False).bases
    cands = [b for b in bases if engine_name in b.get("engines", {})
             and (tick is None or int(b["tick"]) == int(tick))]
    if not cands:
        raise FileNotFoundError(
            f"no advertised base for engine '{engine_name}'"
            + (f" at tick {tick}" if tick is not None else ""))
    step = int(max(cands, key=lambda b: int(b["tick"]))
               ["engines"][engine_name])
    corrupt_snapshot(base_manager(log_dir, engine_name), step, keep_fraction)
    return step

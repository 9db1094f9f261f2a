"""Append-only segmented firehose log (the §4.2 "rewindable hose").

The PyTorch port's own copy of the JAX package's ``streaming/log.py``
(numpy only), on the port's ``QueryEvents``/``TweetBatch``. The segment
and manifest formats are the JAX package's, so segments written by either
package are read by the other. The writer carries a manifest's compaction
``bases`` through untouched and the reader reports them; the port has no
``LogCompactor`` yet, so ``streaming.replay`` refuses a log that
advertises one.

The paper's recovery story leans on the message queue: "a (re)started
instance can rewind to an earlier point in the [fire]hose and consume
messages at a faster rate than real time to catch up to the present". The
deployed system got that property from the firehose infrastructure itself;
here the hose is synthetic, so we make it rewindable with a durable log.

Design — one log = one directory (several named logs may share it):

  * **segments**: ``<name>-<first>-<last>.npz`` files, each holding a stack
    of consecutive micro-batch ticks (query events + tweet grams). Segments
    are written whole: serialized to memory, checksummed, written to a
    ``.tmp_*`` file, fsynced, then atomically renamed into place.
  * **manifest**: ``<name>-MANIFEST.json`` lists the sealed segments (file,
    tick range, sha256). It is rewritten atomically after every seal, so
    readers always see a consistent prefix of the log.
  * **rotation** by tick count (``ticks_per_segment``), and also whenever
    the micro-batch shapes change (a segment is one stackable block).
  * **codec**: sealed segment blobs go through ``streaming.codec`` —
    fingerprint lanes XOR-delta encoded, then zlib (exact round-trip).
    The manifest records the codec id plus BOTH digests: ``sha256`` over
    the on-disk (compressed) bytes — what the reader's integrity pass and
    ``corrupt_segment`` operate on, unchanged — and ``raw_sha256`` over
    the uncompressed npz body, re-verified at decode time. Every seal
    uses ``DEFAULT_CODEC``; readers also decode the plain npz that the
    JAX package writes with ``codec="raw"``.
  * **retention**: ``keep_segments`` newest segments are kept; older ones
    leave the manifest first, then their files are unlinked — a reader can
    never observe a manifested-but-deleted segment. Without a compaction
    base in the manifest, retention must cover the oldest snapshot offset
    recovery may restore from: with delta snapshots
    (``CheckpointManager.full_interval > 1``) a torn chain falls back to
    the last *full* snapshot, so size ``keep_segments`` for a
    full-snapshot interval of ticks, not a delta interval. Once a
    ``LogCompactor`` advertises a base (replay floor) in the manifest,
    the guard below applies: ``_retain`` will never trim a segment that
    holds ticks at/after the newest base — it warns and keeps the
    segment instead of silently making replay-from-base impossible.
  * **compaction bases**: the manifest's ``bases`` list advertises folded
    base snapshots (``{"tick", "epoch", "engines": {name: step}}``):
    engine state reflecting every tick ``< tick``, written through
    ``CheckpointManager`` by ``streaming.compaction.LogCompactor``. The
    newest base ≤ a requested tick is the replay floor: readers/recovery
    restore it and replay only ``[tick, head]``. Only the compactor
    rewrites ``bases`` (epoch-fenced, same manifest rename as the
    writer); the writer carries them through untouched on every
    manifest rewrite.
  * **torn-tail detection**: a crashed writer can leave (a) ``.tmp_*``
    scratch files, (b) a partial segment file at its final name that never
    made the manifest, or (c) — with non-atomic filesystems — a manifested
    segment whose bytes are short/corrupt. The reader validates checksums
    in order and truncates the log at the first bad segment: everything up
    to the last complete segment replays, the torn tail is ignored (the
    paper's stance: losing a little state is tolerable, §4.2).
  * **epoch fencing**: the manifest carries a monotonic leadership
    ``epoch``. A failing-over leader calls ``assume_epoch(e)`` — which
    re-syncs its segment view and durably rewrites the manifest at the new
    epoch BEFORE any of its appends — and from then on any writer still
    holding an older epoch is a *zombie*: its ``append``/``flush`` re-reads
    the on-disk epoch and raises :class:`WriterFencedError` without writing
    a segment or touching the manifest. The fencing token thus rides in the
    same atomically-renamed manifest that defines log visibility, so "the
    manifest the new leader owns" and "the manifest readers trust" are one
    object (``distributed.fault_tolerance.ReplicaGroup`` bumps the epoch on
    every leadership change).

The reader seeks by tick and yields stacked chunks ready for the fused
``engine.ingest_many`` replay step.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import tempfile
import warnings
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ..data.stream import QueryEvents, TweetBatch
from .codec import DEFAULT_CODEC, decode_payload, encode_payload

_FMT = "{name}-{first:012d}-{last:012d}.npz"
_SEG_RE = re.compile(r"^(?P<name>.+)-(?P<first>\d{12})-(?P<last>\d{12})\.npz$")

# npz lanes of one segment (leading dim R = ticks in the segment)
_LANES = ("ticks", "sess_fp", "q_fp", "src", "q_valid", "grams", "t_valid")


class LogChunk(NamedTuple):
    """A stack of consecutive logged ticks (host numpy, ready to replay)."""
    ticks: np.ndarray     # i64[R]
    sess_fp: np.ndarray   # u64[R, B]
    q_fp: np.ndarray      # u64[R, B]
    src: np.ndarray       # i32[R, B]
    q_valid: np.ndarray   # bool[R, B]
    grams: np.ndarray     # u64[R, T, G]
    t_valid: np.ndarray   # bool[R, T]

    @property
    def n_ticks(self) -> int:
        return self.ticks.shape[0]

    def query_events(self, i: int) -> Optional[QueryEvents]:
        if self.q_fp.shape[1] == 0:
            return None
        return QueryEvents(sess_fp=self.sess_fp[i], q_fp=self.q_fp[i],
                           src=self.src[i], valid=self.q_valid[i])

    def tweet_batch(self, i: int) -> Optional[TweetBatch]:
        if self.grams.shape[1] == 0 or self.grams.shape[2] == 0:
            return None
        return TweetBatch(grams=self.grams[i], valid=self.t_valid[i])


@dataclasses.dataclass(frozen=True)
class Segment:
    file: str
    first: int
    last: int
    n_ticks: int
    sha256: str               # over the on-disk (possibly compressed) bytes
    codec: str = "raw"        # pre-codec manifests decode as raw npz
    raw_sha256: Optional[str] = None   # over the uncompressed npz body


def newest_base_tick(bases: List[Dict]) -> Optional[int]:
    """Replay floor of a manifest's ``bases`` list: the newest advertised
    base tick (state covers every tick strictly below it), or None."""
    return max((int(b["tick"]) for b in bases), default=None)


class WriterFencedError(RuntimeError):
    """A zombie ex-leader's append/flush was rejected: the on-disk manifest
    carries a newer leadership epoch than this writer holds. Nothing was
    written — neither segment bytes nor manifest."""


def _record_arrays(tick: int, events: Optional[QueryEvents],
                   tweets: Optional[TweetBatch]) -> Dict[str, np.ndarray]:
    if events is None:
        sess = q = np.zeros((0,), np.uint64)
        src = np.zeros((0,), np.int32)
        qv = np.zeros((0,), bool)
    else:
        sess = np.asarray(events.sess_fp, np.uint64)
        q = np.asarray(events.q_fp, np.uint64)
        src = np.asarray(events.src, np.int32)
        qv = np.asarray(events.valid, bool)
    if tweets is None:
        grams = np.zeros((0, 0), np.uint64)
        tv = np.zeros((0,), bool)
    else:
        grams = np.asarray(tweets.grams, np.uint64)
        tv = np.asarray(tweets.valid, bool)
    return {"ticks": np.int64(tick), "sess_fp": sess, "q_fp": q, "src": src,
            "q_valid": qv, "grams": grams, "t_valid": tv}


class FirehoseLogWriter:
    """Single-writer append path (leader-elected in a replica group —
    see ``distributed.fault_tolerance.ReplicaGroup.log_append``)."""

    def __init__(self, directory: str, ticks_per_segment: int = 8,
                 keep_segments: int = 0, name: str = "firehose",
                 epoch: int = 0):
        if ticks_per_segment <= 0:
            raise ValueError(f"ticks_per_segment must be > 0, not "
                             f"{ticks_per_segment}")
        self.dir = directory
        self.name = name
        self.ticks_per_segment = ticks_per_segment
        self.keep_segments = keep_segments  # 0 = keep everything
        # leadership epoch this writer believes it holds; appends are fenced
        # against the manifest's epoch (see ``assume_epoch``)
        self.epoch = int(epoch)
        os.makedirs(directory, exist_ok=True)
        self._buf: List[Dict[str, np.ndarray]] = []
        self._buf_ticks: List[int] = []
        self._dead = False
        doc = _load_manifest_doc(directory, name)
        self.segments: List[Segment] = [Segment(**s)
                                        for s in doc.get("segments", [])]
        # compaction bases are owned by the LogCompactor; the writer only
        # carries them through its manifest rewrites
        self.bases: List[Dict] = list(doc.get("bases", []))

    # -- state --
    @property
    def last_tick(self) -> Optional[int]:
        if self._buf_ticks:
            return self._buf_ticks[-1]
        return self.segments[-1].last if self.segments else None

    def _manifest_path(self) -> str:
        return _manifest_path(self.dir, self.name)

    # -- leadership epoch / fencing --
    def assume_epoch(self, epoch: int) -> "FirehoseLogWriter":
        """Take over as the single log writer at leadership ``epoch``.

        Re-syncs the segment view from disk, verifies the epoch is not
        older than the manifest's, then durably rewrites the manifest at
        the new epoch — BEFORE any append. That ordering is the fence: the
        moment the bump lands, a zombie ex-leader's next ``append``/
        ``flush`` observes ``manifest.epoch > writer.epoch`` and is
        rejected, even if the new leader has not sealed a segment yet.
        """
        doc = _load_manifest_doc(self.dir, self.name)
        cur = int(doc.get("epoch", 0))
        if int(epoch) < cur:
            raise WriterFencedError(
                f"cannot assume epoch {epoch}: manifest already at {cur}")
        self.segments = [Segment(**s) for s in doc.get("segments", [])]
        self.bases = list(doc.get("bases", []))
        self.epoch = int(epoch)
        self._dead = False
        self._write_manifest()
        return self

    def _check_fence(self) -> None:
        cur = int(_load_manifest_doc(self.dir, self.name).get("epoch", 0))
        if cur > self.epoch:
            # fenced writers stay fenced: drop the buffer so a later retry
            # cannot resurrect the stray ticks either
            self._buf, self._buf_ticks = [], []
            self._dead = True
            raise WriterFencedError(
                f"writer (epoch {self.epoch}) fenced by manifest epoch "
                f"{cur}: a newer leader owns log '{self.name}'")

    def _sync_from_disk(self) -> None:
        """Fence-check, then adopt the on-disk manifest as truth. Called at
        segment start AND before every seal: a ``LogCompactor`` may have
        rewritten the manifest (new bases, floor-trimmed segments) between
        this writer's appends, and a stale cached view would resurrect
        segments whose files were already unlinked."""
        self._check_fence()
        doc = _load_manifest_doc(self.dir, self.name)
        self.segments = [Segment(**s) for s in doc.get("segments", [])]
        self.bases = list(doc.get("bases", []))

    # -- append path --
    def append(self, tick: int, events: Optional[QueryEvents],
               tweets: Optional[TweetBatch]) -> None:
        """Append one tick's micro-batches. Ticks must be increasing."""
        if self._dead:
            raise RuntimeError("writer was killed (failure injection)")
        if not self._buf:
            # segment start: re-sync from the on-disk manifest. A standby
            # replica's writer may have been constructed long before it won
            # leadership (ReplicaGroup.log_append failover); without the
            # re-sync its stale cached view would both accept duplicate
            # ticks and rewrite the manifest without the old leader's
            # segments. One small json read per segment — which doubles as
            # the fencing read: a zombie is rejected before it buffers.
            self._sync_from_disk()
        tick = int(tick)
        last = self.last_tick
        if last is not None and tick <= last:
            raise ValueError(f"non-monotonic append: tick {tick} <= {last}")
        rec = _record_arrays(tick, events, tweets)
        if self._buf and any(
                rec[k].shape != self._buf[-1][k].shape for k in _LANES[1:]):
            self.flush()   # shape change: rotate so segments stay stackable
        self._buf.append(rec)
        self._buf_ticks.append(tick)
        if len(self._buf) >= self.ticks_per_segment:
            self.flush()

    def _serialize_buffer(self) -> Tuple[bytes, str, Dict]:
        """The segment wire format, shared with the failure injector (one
        definition — torn-tail tests must tear exactly what flush writes).
        Returns (encoded blob, final segment file name, codec info)."""
        payload = {k: np.stack([r[k] for r in self._buf]) for k in _LANES}
        blob, info = encode_payload(payload, codec=DEFAULT_CODEC)
        fname = _FMT.format(name=self.name, first=self._buf_ticks[0],
                            last=self._buf_ticks[-1])
        return blob, fname, info

    def flush(self) -> Optional[Segment]:
        """Seal the buffered ticks as one segment (atomic rename).

        Fenced: the manifest epoch is re-read first — a zombie ex-leader's
        seal raises :class:`WriterFencedError` before any bytes land."""
        if not self._buf:
            return None
        self._sync_from_disk()
        blob, fname, info = self._serialize_buffer()
        digest = hashlib.sha256(blob).hexdigest()
        fd, tmp = tempfile.mkstemp(dir=self.dir,
                                   prefix=f".tmp_{self.name}_seg_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, os.path.join(self.dir, fname))
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        seg = Segment(fname, self._buf_ticks[0], self._buf_ticks[-1],
                      len(self._buf), digest, codec=info["codec"],
                      raw_sha256=info.get("raw_sha256"))
        self.segments.append(seg)
        self._buf, self._buf_ticks = [], []
        self._write_manifest()
        self._retain()
        return seg

    def close(self) -> None:
        self.flush()

    # -- manifest + retention --
    def _write_manifest(self) -> None:
        doc = {"name": self.name, "version": 1, "epoch": self.epoch,
               "segments": [dataclasses.asdict(s) for s in self.segments],
               "bases": self.bases}
        fd, tmp = tempfile.mkstemp(dir=self.dir,
                                   prefix=f".tmp_{self.name}_man_")
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, self._manifest_path())

    def _retain(self) -> None:
        if self.keep_segments <= 0 or len(self.segments) <= self.keep_segments:
            return
        n_drop = len(self.segments) - self.keep_segments
        floor = newest_base_tick(self.bases)
        if floor is not None:
            # Guard: with a compaction base advertised, replay starts at the
            # base tick — a segment holding any tick >= the newest base is
            # load-bearing for replay-from-base and must never be trimmed by
            # blunt keep-N retention (segments are tick-ordered, so the
            # droppable ones form a prefix). Warn-and-clamp rather than
            # raise: the leader's append path must keep the hose moving.
            safe = sum(1 for s in self.segments if s.last < floor)
            if n_drop > safe:
                warnings.warn(
                    f"keep_segments={self.keep_segments} would trim "
                    f"{n_drop - safe} segment(s) at/after the newest "
                    f"compaction base (tick {floor}) of log "
                    f"'{self.name}'; keeping them — rely on the "
                    f"LogCompactor's floor-based retention instead",
                    RuntimeWarning, stacklevel=2)
                n_drop = safe
        if n_drop <= 0:
            return
        drop, self.segments = (self.segments[:n_drop],
                               self.segments[n_drop:])
        self._write_manifest()   # readers stop seeing them first
        for seg in drop:
            try:
                os.unlink(os.path.join(self.dir, seg.file))
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Failure injection (the bench/test harness "kills" the writer mid-segment).
# ---------------------------------------------------------------------------

def kill_writer_mid_segment(writer: FirehoseLogWriter,
                            torn_fraction: float = 0.5) -> Optional[str]:
    """Simulate a writer crash mid-segment write.

    The buffered (unsealed) ticks are flushed as a TORN segment: a partial
    npz byte prefix written directly at its final name, never recorded in
    the manifest — what a crashed non-atomic writer leaves behind. The
    writer is dead afterwards (appends raise). Returns the torn file name
    (None if the buffer was empty — the crash then tore nothing).
    """
    fname = None
    if writer._buf:
        blob, fname, _info = writer._serialize_buffer()
        n = max(1, int(len(blob) * torn_fraction))
        with open(os.path.join(writer.dir, fname), "wb") as f:
            f.write(blob[:n])
        writer._buf, writer._buf_ticks = [], []
    writer._dead = True
    return fname


def slow_io(obj, methods: Tuple[str, ...], delay_s: float):
    """Latency injector: wrap the named bound methods of ``obj`` so each
    call first sleeps ``delay_s`` (a degraded disk / network filesystem).

    Chaos-harness companion to :func:`kill_writer_mid_segment` /
    :func:`corrupt_segment`: those test crash recovery, this tests the
    overload ladder — slow segment seals inflate step latency, which the
    SLO tracker must absorb by batching/shedding instead of stalling the
    hose. Works on any object (writers, readers, checkpoint managers).
    Returns ``obj``; restore by calling the returned undo callable kept at
    ``obj._slow_io_undo`` (last injection wins).
    """
    import time as _time
    originals = [(m, getattr(obj, m)) for m in methods]

    def _wrap(fn):
        def slowed(*a, **kw):
            _time.sleep(delay_s)
            return fn(*a, **kw)
        return slowed

    for m, fn in originals:
        setattr(obj, m, _wrap(fn))

    def undo():
        for m, fn in originals:
            setattr(obj, m, fn)

    obj._slow_io_undo = undo
    return obj


def flaky_io(obj, methods: Tuple[str, ...], n_failures: int = 1,
             exc=OSError):
    """Transient-fault injector: wrap the named bound methods of ``obj`` so
    the first ``n_failures`` calls (counted across all wrapped methods)
    raise ``exc`` before the real call runs — an NFS hiccup / EINTR-style
    blip rather than ``slow_io``'s latency or ``corrupt_segment``'s
    permanent damage. The reader's bounded retry must absorb these.
    Returns ``obj``; restore via ``obj._flaky_io_undo`` (last wins)."""
    originals = [(m, getattr(obj, m)) for m in methods]
    budget = {"left": int(n_failures), "raised": 0}

    def _wrap(fn):
        def flaked(*a, **kw):
            if budget["left"] > 0:
                budget["left"] -= 1
                budget["raised"] += 1
                raise exc("injected transient I/O failure")
            return fn(*a, **kw)
        return flaked

    for m, fn in originals:
        setattr(obj, m, _wrap(fn))

    def undo():
        for m, fn in originals:
            setattr(obj, m, fn)

    obj._flaky_io_undo = undo
    obj._flaky_io_stats = budget
    return obj


def corrupt_segment(directory: str, seg: Segment,
                    keep_fraction: float = 0.5) -> None:
    """Truncate a sealed segment's bytes in place (torn write on a
    non-atomic filesystem). The reader's checksum pass must drop it and
    everything after it."""
    path = os.path.join(directory, seg.file)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: max(1, int(len(blob) * keep_fraction))])


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _manifest_path(directory: str, name: str) -> str:
    return os.path.join(directory, f"{name}-MANIFEST.json")


def _load_manifest_doc(directory: str, name: str) -> Dict:
    """The full manifest document (segments + leadership epoch)."""
    path = _manifest_path(directory, name)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _load_manifest(directory: str, name: str) -> List[Segment]:
    return [Segment(**s)
            for s in _load_manifest_doc(directory, name).get("segments", [])]


def log_epoch(directory: str, name: str = "firehose") -> int:
    """The current leadership epoch recorded in the log manifest."""
    return int(_load_manifest_doc(directory, name).get("epoch", 0))


def log_bases(directory: str, name: str = "firehose") -> List[Dict]:
    """The compaction bases advertised in the log manifest (tick order)."""
    return list(_load_manifest_doc(directory, name).get("bases", []))


class FirehoseLogReader:
    """Seek-by-tick reader with torn-tail truncation.

    ``refresh()`` re-validates the manifest against the files on disk:
    segments are accepted in order while their bytes verify (sha256); the
    first bad/missing segment truncates the readable log there. Files at
    segment names that the manifest does not list (a crashed writer's torn
    tail) are counted and ignored.

    Transient I/O errors (an NFS blip mid-replay) are absorbed by a
    bounded retry-with-backoff around every segment read: up to
    ``io_retries`` re-reads, sleeping ``io_backoff_s * 2**attempt`` between
    attempts (``n_io_retries`` counts them). Only after the budget is
    exhausted does the error surface — as a bad segment during
    verification (truncating the readable log there, same as corruption)
    or as the raised ``OSError`` during a chunk read.
    """

    def __init__(self, directory: str, name: str = "firehose",
                 verify: bool = True, io_retries: int = 2,
                 io_backoff_s: float = 0.005):
        self.dir = directory
        self.name = name
        self.verify = verify
        self.io_retries = int(io_retries)
        self.io_backoff_s = float(io_backoff_s)
        self.segments: List[Segment] = []
        self.bases: List[Dict] = []     # compaction bases (replay floors)
        self.n_truncated_segments = 0   # manifested but failed verification
        self.n_unmanifested_files = 0   # torn tail beyond the manifest
        self.n_io_retries = 0           # transient read errors absorbed
        self.refresh()

    def refresh(self) -> "FirehoseLogReader":
        if not os.path.isdir(self.dir):
            # no log yet (e.g. a frontend starting before the backend's
            # writer): an empty log, not an error
            self.segments = []
            self.bases = []
            self.n_truncated_segments = self.n_unmanifested_files = 0
            return self
        doc = _load_manifest_doc(self.dir, self.name)
        self.bases = list(doc.get("bases", []))
        manifested = [Segment(**s) for s in doc.get("segments", [])]
        good: List[Segment] = []
        for seg in manifested:
            path = os.path.join(self.dir, seg.file)
            if not os.path.exists(path) or not self._ok(path, seg):
                break
            good.append(seg)
        self.n_truncated_segments = len(manifested) - len(good)
        self.segments = good
        listed = {s.file for s in manifested}
        self.n_unmanifested_files = sum(
            1 for f in os.listdir(self.dir)
            if _SEG_RE.match(f) and _SEG_RE.match(f).group("name") == self.name
            and f not in listed)
        return self

    def _read_bytes(self, path: str) -> bytes:
        """The one raw segment read (injection point for ``flaky_io``)."""
        with open(path, "rb") as f:
            return f.read()

    def _read_bytes_retry(self, path: str) -> bytes:
        """Bounded retry-with-backoff over ``_read_bytes``: a transient
        hiccup must not surface as a hard replay failure."""
        import time as _time
        for attempt in range(self.io_retries + 1):
            try:
                return self._read_bytes(path)
            except OSError:
                if attempt >= self.io_retries:
                    raise
                self.n_io_retries += 1
                if self.io_backoff_s > 0:
                    _time.sleep(self.io_backoff_s * (2 ** attempt))
        raise AssertionError("unreachable")

    def _ok(self, path: str, seg: Segment) -> bool:
        if not self.verify:
            return True
        try:
            blob = self._read_bytes_retry(path)
        except OSError:
            return False
        return hashlib.sha256(blob).hexdigest() == seg.sha256

    # -- seek info --
    def first_tick(self) -> Optional[int]:
        return self.segments[0].first if self.segments else None

    def last_tick(self) -> Optional[int]:
        return self.segments[-1].last if self.segments else None

    # -- reads --
    def _load_segment(self, seg: Segment) -> LogChunk:
        blob = self._read_bytes_retry(os.path.join(self.dir, seg.file))
        payload, _info = decode_payload(blob)
        return LogChunk(**{k: payload[k] for k in _LANES})

    def read_chunks(self, from_tick: int, chunk_ticks: Optional[int] = None,
                    upto_tick: Optional[int] = None) -> Iterator[LogChunk]:
        """Yield stacked chunks covering ticks in [from_tick, upto_tick).

        Without ``chunk_ticks``, yields one chunk per segment (sliced at the
        seek point). With it, re-chunks across segment boundaries into
        uniform ``chunk_ticks``-sized stacks (plus a final remainder) so the
        replay step compiles for at most two distinct shapes.
        """
        pend: Optional[LogChunk] = None
        for seg in self.segments:
            if seg.last < from_tick:
                continue
            if upto_tick is not None and seg.first >= upto_tick:
                break
            chunk = self._load_segment(seg)
            m = chunk.ticks >= from_tick
            if upto_tick is not None:
                m &= chunk.ticks < upto_tick
            if not m.all():
                chunk = LogChunk(*(a[m] for a in chunk))
            if chunk.n_ticks == 0:
                continue
            if chunk_ticks is None:
                yield chunk
                continue
            if pend is not None:
                # merge only consecutive, shape-compatible ticks: a chunk
                # must never hide a tick gap inside it (replay decides per
                # chunk whether skipping a gap is allowed)
                if (int(pend.ticks[-1]) + 1 == int(chunk.ticks[0])
                        and all(p.shape[1:] == c.shape[1:]
                                for p, c in zip(pend, chunk))):
                    chunk = LogChunk(*(np.concatenate([p, c])
                                       for p, c in zip(pend, chunk)))
                else:          # gap or shape break: emit what we have
                    yield pend
                pend = None
            off = 0
            while chunk.n_ticks - off >= chunk_ticks:
                yield LogChunk(*(a[off:off + chunk_ticks] for a in chunk))
                off += chunk_ticks
            if off < chunk.n_ticks:
                pend = LogChunk(*(a[off:] for a in chunk))
        if pend is not None:
            yield pend

    def read_ticks(self, from_tick: int, upto_tick: Optional[int] = None
                   ) -> Iterator[Tuple[int, Optional[QueryEvents],
                                       Optional[TweetBatch]]]:
        """Per-tick view (live-rate handoff / reference comparisons)."""
        for chunk in self.read_chunks(from_tick, upto_tick=upto_tick):
            for i in range(chunk.n_ticks):
                yield (int(chunk.ticks[i]), chunk.query_events(i),
                       chunk.tweet_batch(i))

    def repair(self) -> int:
        """Delete THIS log's torn-tail debris (unmanifested segment files
        + its name-scoped tmp scratch) so a restarted writer starts clean.
        Never touches other named logs sharing the directory — their
        writer may hold a tmp file mid-seal. Returns #files."""
        if not os.path.isdir(self.dir):
            return 0
        listed = {s.file for s in _load_manifest(self.dir, self.name)}
        n = 0
        for f in os.listdir(self.dir):
            m = _SEG_RE.match(f)
            torn = (m and m.group("name") == self.name and f not in listed)
            if torn or f.startswith(f".tmp_{self.name}_"):
                try:
                    os.unlink(os.path.join(self.dir, f))
                    n += 1
                except OSError:
                    pass
        self.refresh()
        return n

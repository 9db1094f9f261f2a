"""Durable firehose log + faster-than-real-time catch-up replay (§4.2),
log compaction, and overload control of the live path.

The PyTorch port of the JAX package's ``streaming`` package:

  * :mod:`.codec` — the ``FHC1`` blob container (segments and snapshots);
  * :mod:`.log` — the segmented firehose log, its epochs and fencing, and
    the failure injectors;
  * :mod:`.replay` — snapshot restore + catch-up replay + handoff, for one
    engine and for the whole rt + bg serving stack (``recover_service``),
    hopping onto the newest compaction base newer than an engine's own
    offset;
  * :mod:`.compaction` — :class:`LogCompactor` folds the sealed log prefix
    into per-engine base snapshots advertised in the log manifest and
    trims retention to ``[oldest retained base, head]``: bounded disk, and
    replay from zero stays possible (restore the newest base, replay the
    tail). Epoch-fenced like the writer; a torn newest base falls back to
    the previous one (``corrupt_base`` injects it), counted;
  * :mod:`.overload` — :class:`OverloadController` in front of the serving
    stack: lag-adaptive micro-batching over ``step_many`` and a
    degradation ladder (shed rt ranking -> stretch bg ranking -> sample
    tail ingest and shed tweets), every shed counted, admission a pure
    hash run before the log append so a mid-shed crash replays bit for
    bit;
  * :mod:`.workload` — the flash-crowd firehose generator (Zipf + topic
    drift, breaking-news spikes, spam bursts, multilingual sessions),
    pure in ``(seed, t)``.

The paper's backend is deliberately volatile: durability comes from
persisting results every rank cycle and from rewinding into the firehose
and replaying it faster than real time.
"""
from .codec import (CodecError, decode_payload, encode_payload,
                    xor_delta_decode, xor_delta_encode)
from .compaction import (CompactionConfig, LogCompactor, corrupt_base,
                         restore_from_base)
from .log import (FirehoseLogReader, FirehoseLogWriter, LogChunk,
                  WriterFencedError, corrupt_segment, flaky_io,
                  kill_writer_mid_segment, log_bases, log_epoch, slow_io)
from .overload import (DegradationLadder, LatencyTracker, OverloadController,
                       SLOConfig, admit_events, admit_tweets)
from .replay import (CatchUpController, ReplayConfig, chunk_to_stack,
                     recover_engine, recover_service)
from .workload import (FirehoseWorkload, SpamSpec, SpikeSpec, WorkloadConfig,
                       bucket_size)

__all__ = [
    "FirehoseLogReader", "FirehoseLogWriter", "LogChunk",
    "WriterFencedError", "corrupt_segment", "flaky_io",
    "kill_writer_mid_segment", "log_bases", "log_epoch", "slow_io",
    "CodecError", "decode_payload", "encode_payload",
    "xor_delta_decode", "xor_delta_encode",
    "CompactionConfig", "LogCompactor", "corrupt_base",
    "restore_from_base",
    "CatchUpController", "ReplayConfig", "chunk_to_stack", "recover_engine",
    "recover_service",
    "OverloadController", "SLOConfig", "DegradationLadder", "LatencyTracker",
    "admit_events", "admit_tweets",
    "FirehoseWorkload", "WorkloadConfig", "SpikeSpec", "SpamSpec",
    "bucket_size",
]

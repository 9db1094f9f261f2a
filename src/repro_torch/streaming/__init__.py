"""Durable firehose log + faster-than-real-time catch-up replay (§4.2).

The PyTorch port of the JAX package's ``streaming`` package, for what is
ported: :mod:`.codec` (the ``FHC1`` blob container), :mod:`.log` (the
segmented firehose log, its epochs and fencing, and the failure
injectors) and :mod:`.replay` (snapshot restore + catch-up replay +
handoff, for one engine and for the whole rt + bg serving stack,
``recover_service``). The paper's backend is deliberately volatile:
durability comes from persisting results every rank cycle and from
rewinding into the firehose and replaying it faster than real time. Log
compaction, overload control and the workload generator are not ported
yet.
"""
from .codec import (CodecError, decode_payload, encode_payload,
                    xor_delta_decode, xor_delta_encode)
from .log import (FirehoseLogReader, FirehoseLogWriter, LogChunk,
                  WriterFencedError, corrupt_segment, flaky_io,
                  kill_writer_mid_segment, log_bases, log_epoch, slow_io)
from .replay import (CatchUpController, ReplayConfig, chunk_to_stack,
                     recover_engine, recover_service)

__all__ = [
    "FirehoseLogReader", "FirehoseLogWriter", "LogChunk",
    "WriterFencedError", "corrupt_segment", "flaky_io",
    "kill_writer_mid_segment", "log_bases", "log_epoch", "slow_io",
    "CodecError", "decode_payload", "encode_payload",
    "xor_delta_decode", "xor_delta_encode",
    "CatchUpController", "ReplayConfig", "chunk_to_stack", "recover_engine",
    "recover_service",
]

"""Segment codec: fingerprint delta-encoding + compressed blob container.

The PyTorch port's own copy of the JAX package's ``streaming/codec.py``
(numpy only): the same ``FHC1`` wire format, ``xor64`` fingerprint
transform and ``raw_sha256`` check, so a blob written by either package
decodes in the other to equal arrays. ``encode_payload`` and
``decode_payload`` also take an optional ``times`` dict that they add
their steps' seconds to (the snapshot cost split).

Sealed firehose-log segments and ``CheckpointManager`` payloads are npz
blobs of mostly-integer lanes. Sessions repeat heavily (a user issues many
queries inside one session window) and the query fingerprints themselves
follow the Zipf head, so the u64 fingerprint lanes are highly redundant —
but only *exactly* redundant: the replay contract is bit-for-bit, so any
encoding here must round-trip exactly.

Two layers, both exact:

  * **fingerprint transform** (``xor_delta_encode``): each u64 lane is
    XORed with its predecessor in flattened order (sort-free — the lane
    order IS the log order, which replay depends on). A repeated
    fingerprint becomes a zero word; a near-repeat (same session, new
    query) becomes a low-entropy word. The inverse is a cumulative XOR.
    This is the "offset-vs-previous-occurrence" family from delta-encoded
    postings, without the sort that would destroy replay order.
  * **compression** (zlib, stdlib — the container records the codec id so
    an lz4/zstd codec can slot in without a format change).

Wire format of an encoded blob::

    b"FHC1" | u32 header_len | header json (utf-8) | zlib body

    header = {"codec": str, "raw_sha256": hex, "raw_nbytes": int,
              "transforms": {lane_name: "xor64"}}

``raw_sha256`` is the digest of the *uncompressed* npz body — verified on
every decode, so a decompression that "succeeds" on corrupt bytes still
cannot hand back silently-wrong arrays. The on-disk manifest keeps its own
sha256 over the final (compressed) blob, so the reader's integrity pass
and the ``corrupt_segment``/``corrupt_snapshot`` failure injectors work on
file bytes exactly as before.

A blob that does not start with the magic is treated as a legacy raw npz —
old logs and old snapshot dirs decode transparently.
"""
from __future__ import annotations

import hashlib
import io
import json
import struct
import time
import zlib
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

MAGIC = b"FHC1"

#: codec ids -> (compress, decompress). "raw" bypasses the container.
RAW = "raw"
ZLIB = "zlib"                 # container + zlib, no lane transform
FP_ZLIB = "fpx-zlib"          # xor-delta the named fp lanes, then zlib
DEFAULT_CODEC = FP_ZLIB
CODECS = (RAW, ZLIB, FP_ZLIB)

#: the firehose-log lanes that hold u64 fingerprints (see log._LANES)
FP_LANES = ("sess_fp", "q_fp", "grams")


class CodecError(ValueError):
    """A blob failed structural or integrity validation during decode."""


# ---------------------------------------------------------------------------
# Exact integer transforms
# ---------------------------------------------------------------------------

def xor_delta_encode(a: np.ndarray) -> np.ndarray:
    """XOR each element with its predecessor in flattened order.

    Exact for any integer dtype; repeated values become zeros (sessions
    and head queries repeat heavily), which the byte compressor then
    collapses. Sort-free: element order — the log order — is untouched.
    """
    flat = np.ascontiguousarray(a).reshape(-1)
    out = flat.copy()
    if out.size > 1:
        out[1:] ^= flat[:-1]
    return out.reshape(a.shape)


def xor_delta_decode(a: np.ndarray) -> np.ndarray:
    """Inverse of :func:`xor_delta_encode` (cumulative XOR)."""
    flat = np.ascontiguousarray(a).reshape(-1)
    if flat.size > 1:
        flat = np.bitwise_xor.accumulate(flat)
    return flat.reshape(a.shape).astype(a.dtype, copy=False)


_TRANSFORMS = {"xor64": (xor_delta_encode, xor_delta_decode)}


# ---------------------------------------------------------------------------
# Payload <-> blob
# ---------------------------------------------------------------------------

def _savez(payload: Dict[str, np.ndarray]) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, **payload)
    return bio.getvalue()


class _Clock:
    """Adds the seconds since the previous ``lap`` to ``times[name]``; a
    no-op without a dict."""

    def __init__(self, times: Optional[Dict[str, float]]):
        self.times = times
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        if self.times is not None:
            self.times[name] = self.times.get(name, 0.0) + now - self.t
        self.t = now


def encode_payload(payload: Dict[str, np.ndarray],
                   codec: str = DEFAULT_CODEC,
                   fp_lanes: Iterable[str] = FP_LANES,
                   times: Optional[Dict[str, float]] = None
                   ) -> Tuple[bytes, Dict]:
    """Serialize ``payload`` under ``codec``. Returns ``(blob, info)``.

    ``info`` carries ``codec``, ``raw_sha256`` (digest of the uncompressed
    npz body — what the log manifest records next to the on-disk digest)
    and ``raw_nbytes``/``nbytes`` for compression accounting. ``times``
    collects the seconds of ``savez``, ``raw_sha256`` and ``zlib``.
    """
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r} (have {CODECS})")
    clock = _Clock(times)
    if codec == RAW:
        blob = _savez(payload)
        clock.lap("savez")
        sha = hashlib.sha256(blob).hexdigest()
        clock.lap("raw_sha256")
        return blob, {"codec": RAW, "raw_sha256": sha,
                      "raw_nbytes": len(blob), "nbytes": len(blob)}
    transforms: Dict[str, str] = {}
    if codec == FP_ZLIB:
        payload = dict(payload)
        for lane in fp_lanes:
            a = payload.get(lane)
            if a is not None and a.dtype.kind in "ui" and a.size:
                payload[lane] = xor_delta_encode(a)
                transforms[lane] = "xor64"
    body_raw = _savez(payload)
    clock.lap("savez")
    raw_sha = hashlib.sha256(body_raw).hexdigest()
    clock.lap("raw_sha256")
    header = {"codec": codec, "raw_sha256": raw_sha,
              "raw_nbytes": len(body_raw), "transforms": transforms}
    hdr = json.dumps(header, sort_keys=True).encode()
    body = zlib.compress(body_raw, 6)
    blob = MAGIC + struct.pack("<I", len(hdr)) + hdr + body
    clock.lap("zlib")
    return blob, {"codec": codec, "raw_sha256": raw_sha,
                  "raw_nbytes": len(body_raw), "nbytes": len(blob)}


def decode_payload(blob: bytes, times: Optional[Dict[str, float]] = None
                   ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Decode a blob written by :func:`encode_payload` — or a legacy raw
    npz blob (no magic). Returns ``(payload, info)``; raises
    :class:`CodecError` on a structurally bad or integrity-failing blob.
    ``times`` collects the seconds of ``zlib``, ``raw_sha256`` and
    ``npz_load``.
    """
    clock = _Clock(times)
    if not blob.startswith(MAGIC):
        try:
            with np.load(io.BytesIO(blob)) as z:
                payload = {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 — short/garbled npz
            raise CodecError(f"not a codec container nor a loadable npz: "
                             f"{e}") from e
        clock.lap("npz_load")
        return payload, {"codec": RAW, "raw_nbytes": len(blob),
                         "nbytes": len(blob)}
    try:
        (hdr_len,) = struct.unpack("<I", blob[4:8])
        header = json.loads(blob[8:8 + hdr_len].decode())
        body = zlib.decompress(blob[8 + hdr_len:])
    except Exception as e:  # noqa: BLE001 — torn header/body
        raise CodecError(f"corrupt codec container: {e}") from e
    clock.lap("zlib")
    want = header.get("raw_sha256")
    if want is not None and hashlib.sha256(body).hexdigest() != want:
        raise CodecError("decompressed body fails raw_sha256 integrity")
    clock.lap("raw_sha256")
    try:
        with np.load(io.BytesIO(body)) as z:
            payload = {k: z[k] for k in z.files}
    except Exception as e:  # noqa: BLE001
        raise CodecError(f"container body is not a loadable npz: {e}") from e
    for lane, tname in header.get("transforms", {}).items():
        if lane in payload:
            payload[lane] = _TRANSFORMS[tname][1](payload[lane])
    clock.lap("npz_load")
    return payload, {"codec": header.get("codec", ZLIB),
                     "raw_nbytes": header.get("raw_nbytes"),
                     "nbytes": len(blob)}


def lane_compression_report(payload: Dict[str, np.ndarray],
                            codec: str = DEFAULT_CODEC,
                            fp_lanes: Iterable[str] = FP_LANES
                            ) -> Dict[str, Dict[str, float]]:
    """Per-lane raw and encoded byte counts: each lane encoded alone under
    ``codec``, so a reader sees which lane the transform pays for."""
    out: Dict[str, Dict[str, float]] = {}
    for k, a in payload.items():
        blob, _ = encode_payload({k: a}, codec=codec, fp_lanes=fp_lanes)
        raw = int(np.asarray(a).nbytes)
        out[k] = {"raw_bytes": raw, "encoded_bytes": len(blob),
                  "ratio": (raw / len(blob)) if len(blob) else 0.0}
    return out

"""Shared shape-cell builders (copies of the JAX package's ``lm_shapes``
and ``recsys_shapes``)."""
from __future__ import annotations

from typing import Tuple

from ..models.api import ShapeCell

FULL_ATTN_SKIP = ("long_500k needs sub-quadratic attention state; this arch "
                  "is pure full attention (see DESIGN.md §3)")


def lm_shapes(*, swa: bool) -> Tuple[ShapeCell, ...]:
    """The 4 assigned LM shapes. long_500k only runs for SWA archs (ring
    KV cache => constant decode state)."""
    return (
        ShapeCell("train_4k", "train", {"batch": 256, "seq": 4096}),
        ShapeCell("prefill_32k", "prefill",
                  {"batch": 32, "seq": 32768, "cache_len": 32768}),
        ShapeCell("decode_32k", "decode",
                  {"batch": 128, "seq": 32768, "cache_len": 32768}),
        ShapeCell("long_500k", "decode",
                  {"batch": 1, "seq": 524288, "cache_len": 524288},
                  skip=None if swa else FULL_ATTN_SKIP),
    )


def recsys_shapes(n_candidates: int = 1_000_000) -> Tuple[ShapeCell, ...]:
    return (
        ShapeCell("train_batch", "train", {"batch": 65536}),
        ShapeCell("serve_p99", "serve", {"batch": 512}),
        ShapeCell("serve_bulk", "serve", {"batch": 262144}),
        ShapeCell("retrieval_cand", "retrieval",
                  {"batch": 1, "n_candidates": n_candidates}),
    )

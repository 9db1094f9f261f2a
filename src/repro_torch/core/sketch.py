"""Count-min sketch store — the probabilistic point on the paper's
coverage↔memory tradeoff curve (§4.4).

Port of the JAX package's ``core/sketch.py``. Every key is tracked (counts
within overestimation error) in O(depth x width) memory independent of the
key cardinality, at the cost of not being enumerable. It decays like the
exact stores, by one multiply of the whole table.

Keys are (hi, lo) u32 pairs in the port's representation (int32 bit views,
or int64 holding the value); the bucket hashes are bit-identical to the
JAX package's. Updates add with ``index_add_`` under deterministic
algorithms, so two runs on the card give the same table; the functions
return a new sketch and leave their argument as it was, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .hashing import _mix32, mul32, u32
from .stores import deterministic, resolve_device

_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F,
          0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)


class CountMinSketch(NamedTuple):
    table: torch.Tensor   # f32[depth, width]

    @property
    def depth(self) -> int:
        return self.table.shape[0]

    @property
    def width(self) -> int:
        return self.table.shape[1]


def make_sketch(depth: int = 4, width: int = 1 << 16,
                device="cuda") -> CountMinSketch:
    """An empty sketch; on the card unless ``device`` names another."""
    assert width & (width - 1) == 0
    assert depth <= len(_SALTS)
    return CountMinSketch(torch.zeros((depth, width), dtype=torch.float32,
                                      device=resolve_device(device)))


def _rows(sk_depth: int, width: int, key_hi, key_lo) -> torch.Tensor:
    """Per-depth bucket indices for a batch of keys -> i32[depth, B]."""
    hi, lo = u32(key_hi), u32(key_lo)
    idx = [(_mix32(hi ^ s) ^ _mix32(mul32(lo, s))) & (width - 1)
           for s in _SALTS[:sk_depth]]
    return torch.stack(idx).to(torch.int32)


def sketch_update(sk: CountMinSketch, key_hi, key_lo, weights, valid
                  ) -> CountMinSketch:
    D, W = sk.table.shape
    idx = _rows(D, W, key_hi, key_lo)
    w = torch.where(valid, weights, torch.zeros_like(weights))
    table = sk.table.clone()
    with deterministic():
        for d in range(D):
            table[d].index_add_(0, idx[d], w)
    return CountMinSketch(table)


def sketch_query(sk: CountMinSketch, key_hi, key_lo) -> torch.Tensor:
    D, W = sk.table.shape
    idx = _rows(D, W, key_hi, key_lo).to(torch.int64)
    return sk.table.gather(1, idx).min(0).values


def sketch_decay(sk: CountMinSketch, factor) -> CountMinSketch:
    return CountMinSketch(sk.table * factor)

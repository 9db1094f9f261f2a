"""Spelling correction via a pairwise edit-distance variant (paper §4.5).

Port of the JAX package's ``core/spelling.py``: the same function and the
same result, ``{misspelled_fp: (corrected_fp, weighted_distance)}``, in
the same dict order. The paper's periodic batch job compares all queries
observed over a long span with a weighted edit distance (first-character
edits cost more, sigils are stripped, adjacent transpositions are one
edit) and emits A -> B when the distance is small and B is much more
frequent than A.

The JAX function scans 256 x 256 tiles of the (source x candidate) space
on the host and loops over every surviving pair in Python. Here the host
only sorts and encodes; the filter, the distances and the choice of each
source's winner run on the device:

  * sources and candidates are put in the reference's scan order by the
    very same call, ``np.argsort(-weights)`` (unstable; ties decide which
    candidate wins), so sorted weights never increase. The candidates ``b``
    with ``w_b >= freq_boost * w_a`` are therefore the prefix
    ``[0, P[a])``, counted on the host with the reference's own threshold
    expression; a source shorter than ``min_len`` gets ``P = 0``;
  * sources go in blocks against their candidate prefix, each block at
    most :data:`BLOCK_CELLS` (source, candidate) cells. On the device a
    block masks the pairs within ``int(max_distance)`` in length, takes
    them with one ``nonzero`` (the block's one host sync), runs
    ``ops.edit_distance`` on them and keeps, per source, the least
    ``(d, b)`` with ``0 < d <= max_distance`` (the lowest candidate index
    wins a tie, as the reference's strict ``<`` scan keeps) and the first
    candidate index that qualifies at all;
  * the host builds the dict in the reference's insertion order: a source
    enters when it first gets an entry, at
    ``(a // tile, first // tile, a)``. Only indices, chars, lengths and
    prefix counts reach the device; fingerprints stay on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .stores import resolve_device

MAX_QUERY_CHARS = 24
# (source x candidate) cells per device block: the block's pair mask, its
# nonzero() and the gathered pairs stay within a few GiB.
BLOCK_CELLS = 1 << 26
_NONE = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class SpellConfig:
    max_len: int = MAX_QUERY_CHARS
    max_distance: float = 2.0      # weighted-edit acceptance threshold
    min_len: int = 4               # too-short strings are too noisy
    freq_boost: float = 3.0        # weight(B) must exceed boost * weight(A)
    first_char_cost: float = 1.5   # the paper's positional weighting
    tile: int = 256                # the reference's tile: sets dict order


def normalize_query(text: str) -> str:
    """Strip Twitter sigils; lowercase; collapse whitespace."""
    toks = []
    for tok in text.lower().split():
        while tok[:1] in ("@", "#"):
            tok = tok[1:]
        if tok:
            toks.append(tok)
    return " ".join(toks)


def encode_strings(texts: List[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (chars u8[N, max_len] zero-padded, lengths i32[N])."""
    n = len(texts)
    chars = np.zeros((n, max_len), np.uint8)
    lens = np.zeros((n,), np.int32)
    for i, t in enumerate(texts):
        b = t.encode("utf-8")[:max_len]
        chars[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return chars, lens


def scan_order(texts: List[str], weights: np.ndarray, cfg: SpellConfig):
    """The reference's scan order and the strings in it: (order, chars
    u8[N, max_len], lens i32[N], prefix i64[N]), where candidate ``b``
    passes source ``a``'s frequency and length gates iff ``b < prefix[a]``.
    """
    chars, lens = encode_strings([normalize_query(t) for t in texts],
                                 cfg.max_len)
    order = np.argsort(-weights)
    w_s = weights[order]
    thr = cfg.freq_boost * w_s
    prefix = np.searchsorted(-w_s, -thr, side="right").astype(np.int64)
    prefix[np.isnan(thr) | (lens[order] < cfg.min_len)] = 0
    return order, chars[order], lens[order], prefix


def _blocks(prefix: np.ndarray, budget: int):
    """Consecutive source blocks ``(a0, a1, n_cand)`` with
    ``(a1 - a0) * n_cand <= budget`` (at least one source each), where
    ``n_cand`` is the block's longest candidate prefix."""
    n, a0 = len(prefix), 0
    while a0 < n:
        widest = np.maximum.accumulate(prefix[a0:])
        cost = np.arange(1, n - a0 + 1, dtype=np.int64) * widest
        a1 = a0 + max(1, int(np.searchsorted(cost, budget, side="right")))
        yield a0, a1, int(widest[a1 - a0 - 1])
        a0 = a1


def spelling_cycle(
    fps: np.ndarray,
    texts: List[str],
    weights: np.ndarray,
    cfg: SpellConfig = SpellConfig(),
    device="cuda",
    *,
    stats: Optional[dict] = None,
) -> Dict[int, Tuple[int, float]]:
    """All-pairs weighted edit distance over the given queries.

    Returns {misspelled_fp: (corrected_fp, weighted_distance)} keeping, per
    source, the lowest-distance candidate (the more frequent wins a tie).
    Runs on the card unless ``device`` names another; raises where CUDA is
    asked for and absent. ``stats``, if given, receives the number of
    sources, filtered pairs, blocks and the largest block's pairs.
    """
    dev = resolve_device(device)
    n = len(texts)
    order, chars, lens, prefix = scan_order(texts, weights, cfg)
    chars_d = torch.from_numpy(chars).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    prefix_d = torch.from_numpy(prefix).to(dev)
    best = torch.full((n,), _NONE, dtype=torch.int64, device=dev)
    first = torch.full((n,), _NONE, dtype=torch.int64, device=dev)
    max_dlen = int(cfg.max_distance)
    n_pairs, n_blocks, largest = 0, 0, 0
    for a0, a1, n_cand in _blocks(prefix, BLOCK_CELLS):
        if n_cand == 0:
            continue
        cand = torch.arange(n_cand, device=dev)
        la = lens_d[a0:a1, None]
        mask = (cand[None, :] < prefix_d[a0:a1, None]) \
            & ((la - lens_d[None, :n_cand]).abs() <= max_dlen)
        aa, bb = mask.nonzero(as_tuple=True)
        del mask
        n_blocks += 1
        if aa.numel() == 0:
            continue
        aa += a0
        n_pairs += aa.numel()
        largest = max(largest, aa.numel())
        d = kops.edit_distance(chars_d[aa], lens_d[aa], chars_d[bb],
                               lens_d[bb],
                               first_char_cost=cfg.first_char_cost)
        ok = (d > 0) & (d.double() <= cfg.max_distance)
        # d > 0 is finite f32, so its bits order like its value
        key = (d.view(torch.int32).to(torch.int64) << 32) | bb
        best.scatter_reduce_(0, aa, torch.where(ok, key, _NONE), "amin")
        first.scatter_reduce_(0, aa, torch.where(ok, bb, _NONE), "amin")
    if stats is not None:
        stats.update(sources=n, pairs=n_pairs, blocks=n_blocks,
                     largest_batch=largest)
    best, first = best.cpu().numpy(), first.cpu().numpy()
    src = np.nonzero(best != _NONE)[0]
    win = best[src] & 0xFFFFFFFF
    dist = (best[src] >> 32).astype(np.int32).view(np.float32)
    fp_s = np.asarray(fps)[order]
    t = cfg.tile
    out: Dict[int, Tuple[int, float]] = {}
    # a key enters the dict at its source's first entry; a repeated key
    # keeps that place and takes the value assigned last in the scan
    for k in np.lexsort((src, first[src] // t, src // t)):
        out[int(fp_s[src[k]])] = None
    for k in np.lexsort((win, src, win // t, src // t)):
        out[int(fp_s[src[k]])] = (int(fp_s[win[k]]), float(dist[k]))
    return out

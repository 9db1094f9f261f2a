"""Shared comparator for the PyTorch port's parity tests.

Compares two ``state_arrays()`` dicts leaf by leaf (the JAX engine's
``leaf_{i}`` order) under the reference contract of
``tests/test_engine.py``: keys, slot placement, ``n_dropped``, sessions and
tick exact (and, under the region layout, the chain directory, region
fills and owners; for the sharded engine ``n_route_drop`` too); weights within rtol 2e-3; counts within rtol 1e-5. The
layout is read from the number of leaves (26 hash, 27 region). A key that
is live on one side only and whose weight there lies within the weight
tolerance of the prune threshold is a *prune flip*: it is counted and
returned (callers print it), never hidden, and any other key mismatch
fails.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# Leaf indices per cooc layout (JAX flatten order; see
# repro_torch.core.engine._flat_leaves). The qstore comes first, the cooc
# store next, then the sessions and the tick.
QSTORE = dict(key_hi=0, key_lo=1, count=2, last_tick=3, weight=4, n_dropped=5)
LAYOUTS = {
    "hash": dict(
        cooc=dict(key_hi=6, key_lo=7, count=8, dst_hi=9, dst_lo=10,
                  last_tick=11, src_hi=12, src_lo=13, weight=14,
                  n_dropped=15),
        n_leaves=26),
    "region": dict(
        cooc=dict(key_hi=6, key_lo=7, count=8, last_tick=9, weight=10,
                  n_dropped=16),
        # per-region and directory leaves: exact, flips or not
        exact=dict(chain_region=11, chain_hi=12, chain_lo=13,
                   region_fill=14, region_owner=15),
        n_leaves=27),
}
# The sharded engine's ShardedState: the same store leaves (per-shard
# stores concatenated along dim 0), then ``n_route_drop`` after the tick.
SHARDED_LAYOUTS = {
    f"sharded-{name}": dict(layout, n_leaves=layout["n_leaves"] + 1)
    for name, layout in LAYOUTS.items()}
WEIGHT_RTOL = 2e-3
COUNT_RTOL = 1e-5


def _prune_flips(a, b, table, threshold):
    """Slots whose liveness differs between a and b; each must hold a
    weight within the weight tolerance of the prune threshold."""
    live_a = (a[f"leaf_{table['key_hi']}"] != 0) | (a[f"leaf_{table['key_lo']}"] != 0)
    live_b = (b[f"leaf_{table['key_hi']}"] != 0) | (b[f"leaf_{table['key_lo']}"] != 0)
    diff = np.nonzero(live_a != live_b)[0]
    w = np.where(live_a, a[f"leaf_{table['weight']}"],
                 b[f"leaf_{table['weight']}"])[diff]
    near = np.abs(w - threshold) <= WEIGHT_RTOL * threshold
    assert near.all(), f"live-key mismatch away from the prune threshold at slots {diff[~near][:10]}"
    return diff


def compare_states(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                   prune_threshold: float, layout: str = None) -> int:
    """Assert the parity contract between two state dicts; returns the
    number of prune flips (0 means every key and slot matched exactly).
    ``layout`` names a ``SHARDED_LAYOUTS`` entry for sharded states; the
    engine's layouts are told apart by their leaf counts."""
    assert len(a) == len(b)
    if layout is None:
        (layout,) = [v for v in LAYOUTS.values() if v["n_leaves"] == len(a)]
    else:
        layout = SHARDED_LAYOUTS[layout]
        assert layout["n_leaves"] == len(a), (len(a), layout)
    n = layout["n_leaves"]
    for i in range(n):
        x, y = a[f"leaf_{i}"], b[f"leaf_{i}"]
        assert x.dtype == y.dtype and x.shape == y.shape, (i, x.dtype, y.dtype)
    flips = 0
    for table in (QSTORE, layout["cooc"]):
        diff = _prune_flips(a, b, table, prune_threshold)
        flips += len(diff)
        same = np.ones(a[f"leaf_{table['key_hi']}"].shape, bool)
        same[diff] = False
        for name, leaf in table.items():
            x, y = a[f"leaf_{leaf}"], b[f"leaf_{leaf}"]
            if name == "n_dropped":
                np.testing.assert_array_equal(x, y, err_msg=name)
            elif name == "weight":
                np.testing.assert_allclose(x[same], y[same], rtol=WEIGHT_RTOL,
                                           err_msg=name)
            elif name == "count":
                np.testing.assert_allclose(x[same], y[same], rtol=COUNT_RTOL,
                                           err_msg=name)
            else:
                np.testing.assert_array_equal(x[same], y[same], err_msg=name)
    for name, leaf in layout.get("exact", {}).items():
        np.testing.assert_array_equal(a[f"leaf_{leaf}"], b[f"leaf_{leaf}"],
                                      err_msg=name)
    first_session = layout["cooc"]["n_dropped"] + 1
    for i in range(first_session, n):   # sessions and tick
        np.testing.assert_array_equal(a[f"leaf_{i}"], b[f"leaf_{i}"],
                                      err_msg=f"leaf_{i}")
    return flips


def compare_suggestions(a: dict, b: dict) -> float:
    """Suggestion contract: same sources; top-3 scores within rtol 5e-3,
    atol 1e-4; top-3 identities agree for >= 95% of sources. Returns the
    identity agreement share."""
    assert set(a) == set(b)
    agree = 0
    for f in a:
        np.testing.assert_allclose([s for _, s in a[f][:3]],
                                   [s for _, s in b[f][:3]],
                                   rtol=5e-3, atol=1e-4)
        agree += [d for d, _ in a[f][:3]] == [d for d, _ in b[f][:3]]
    share = agree / max(len(a), 1)
    assert share >= 0.95, share
    return share

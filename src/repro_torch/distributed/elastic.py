"""Elastic scaling of the sharded engine: live shard split and merge.

Port of the engine half of the JAX package's ``distributed/elastic.py``.
The replicated fleet (``distributed.fleet``) scales availability; this
scales capacity. :class:`ShardAutoscaler` turns the serving metrics'
pressure (region freelist, replay lag, routing drops) into split and merge
decisions with hysteresis, and :func:`live_reshard` performs the
zero-downtime handoff: re-partition the state
(``core.sharded_engine.reshard_sharded_state``), then replay the ticks
that arrived during the repartition window from the shared firehose log,
so the new shard layout equals a run that resharded with the world
stopped. The old state keeps serving until the new one has caught up; the
swap is a pointer flip.

The JAX file's other half, ``validate_divisibility`` and
``reshard_for_mesh``, places model parameters on a device mesh and is not
part of this module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..core.hashing import split_fp
from ..core.sharded_engine import (ShardedConfig, ShardedState,
                                   make_sharded_ingest_many,
                                   reshard_sharded_state)
from ..streaming.log import LOG_NAME, FirehoseLogReader


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    min_shards: int = 1
    max_shards: int = 64
    split_free_frac: float = 0.10   # split when free-region fraction < this
    split_lag_ticks: float = 8.0    # ... or replay lag exceeds this
    merge_free_frac: float = 0.60   # merge when free fraction > this ...
    merge_lag_ticks: float = 1.0    # ... and lag is at most this
    hold_ticks: int = 3             # hysteresis: pressure must persist


class ShardAutoscaler:
    """Hysteresis-gated split/merge decisions off the serving metrics.

    Feed it one observation per tick; it returns the proposed shard count
    (the current one when there is no action). A single spiky tick never
    reshards: the split signal must persist ``hold_ticks`` consecutive
    observations, and the merge signal likewise (merges also reset on any
    pressure)."""

    def __init__(self, cfg: AutoscaleConfig = AutoscaleConfig()):
        self.cfg = cfg
        self._hot = 0
        self._cold = 0

    def observe(self, n_shards: int, *, free_region_frac: Optional[float],
                lag_ticks: float = 0.0, route_drop_rate: float = 0.0) -> int:
        c = self.cfg
        pressured = ((free_region_frac is not None
                      and free_region_frac < c.split_free_frac)
                     or lag_ticks > c.split_lag_ticks
                     or route_drop_rate > 0.0)
        idle = ((free_region_frac is None
                 or free_region_frac > c.merge_free_frac)
                and lag_ticks <= c.merge_lag_ticks
                and route_drop_rate == 0.0)
        self._hot = self._hot + 1 if pressured else 0
        self._cold = self._cold + 1 if (idle and not pressured) else 0
        if self._hot >= c.hold_ticks and 2 * n_shards <= c.max_shards:
            self._hot = self._cold = 0
            return 2 * n_shards
        if self._cold >= c.hold_ticks and n_shards >= 2 \
                and n_shards // 2 >= c.min_shards:
            self._cold = 0
            return n_shards // 2
        return n_shards


def sharded_pressure(state: ShardedState, base_cfg) -> Dict[str, float]:
    """The autoscaler's inputs from a sharded state: the worst shard's
    free-region fraction (region layout; None otherwise) and the routing
    drops since the last reshard."""
    free_frac = None
    if base_cfg.region_cooc:
        free_frac = float(min((c.region_owner.cpu().numpy() < 0).mean()
                              for c in state.cooc))
    return {"free_region_frac": free_frac,
            "route_drop": int(state.n_route_drop.sum())}


def live_reshard(cfg: ShardedConfig, state: ShardedState, new_n: int,
                 n_shards: int, *, log_dir: Optional[str] = None,
                 log_name: str = LOG_NAME, chunk_ticks: int = 8,
                 device="cuda"):
    """Split or merge a live sharded engine with a zero-downtime handoff.

    Re-partitions ``state`` to ``new_n`` shards, then (when ``log_dir`` is
    given) catches the new state up through the shared firehose log's
    tail: the ticks that arrived while the repartition ran and the old
    state went on serving them. Returns ``(new_state, stats)``; the caller
    swaps serving over once ``stats["replayed_ticks"]`` has covered its
    head. ``n_shards`` takes the place of the JAX function's mesh and must
    equal ``new_n``; the replay runs through
    ``make_sharded_ingest_many(cfg, new_n, device)`` (CUDA unless named),
    whose per-tick state mutations are the live tick step's.
    """
    if n_shards != new_n:
        raise ValueError(f"replaying on {n_shards} shards, want {new_n}")
    new_state, stats = reshard_sharded_state(cfg, state, new_n)
    stats["replayed_ticks"] = 0
    if log_dir is not None:
        reader = FirehoseLogReader(log_dir, name=log_name)
        head = reader.last_tick()
        t0 = int(new_state.tick)
        if head is not None and head + 1 > t0:
            ingest = make_sharded_ingest_many(cfg, new_n, device)
            for chunk in reader.read_chunks(t0, chunk_ticks,
                                            upto_tick=head + 1):
                s_hi, s_lo = split_fp(chunk.sess_fp)
                q_hi, q_lo = split_fp(chunk.q_fp)
                new_state = ingest(new_state, s_hi, s_lo, q_hi, q_lo,
                                   np.asarray(chunk.src, np.int32),
                                   np.asarray(chunk.q_valid, bool))
                stats["replayed_ticks"] += chunk.n_ticks
    return new_state, stats

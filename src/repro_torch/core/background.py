"""Background models + serve-time interpolation (paper §4.5).

"The first [mechanism] involves running the same search assistance backend,
except over data spanning much longer periods of time, but with different
parameter settings (decay, pruning, etc.)" — we instantiate a second engine
with a slow decay config and a lower ranking cadence; the frontend
interpolates its suggestions with the real-time engine's.

Port of the JAX package's ``core/background.py``, overload control
included (``slo``, ``mirrors``, ``drain``; ``streaming/overload.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .engine import EngineConfig, SearchAssistanceEngine
from .stores import resolve_device

ALPHA = 0.7     # the real-time table's weight in the served interpolation


def background_config(rt_cfg: EngineConfig, *, half_life_mult: float = 24.0,
                      rank_every_mult: int = 12) -> EngineConfig:
    """Derive the slow-moving background config from the real-time one."""
    slow_decay = dataclasses.replace(
        rt_cfg.decay,
        half_life_ticks=rt_cfg.decay.half_life_ticks * half_life_mult,
        prune_threshold=rt_cfg.decay.prune_threshold * 0.5,
    )
    return dataclasses.replace(
        rt_cfg,
        decay=slow_decay,
        rank_every=rt_cfg.rank_every * rank_every_mult,
        decay_every=rt_cfg.decay_every * 4,
    )


def interpolate(
    rt: Dict[int, List[Tuple[int, float]]],
    bg: Dict[int, List[Tuple[int, float]]],
    alpha: float = ALPHA,
    k: int = 8,
) -> Dict[int, List[Tuple[int, float]]]:
    """Frontend interpolation of real-time and background suggestion tables.

    score = alpha * rt + (1 - alpha) * bg, union over candidates; each
    source keeps its ``k`` best, ties to the lower destination fingerprint.
    Sources come in the JAX package's order (iteration over the union set).
    """
    out: Dict[int, List[Tuple[int, float]]] = {}
    for src in set(rt) | set(bg):
        merged: Dict[int, float] = {}
        for dst, s in rt.get(src, []):
            merged[dst] = merged.get(dst, 0.0) + alpha * s
        for dst, s in bg.get(src, []):
            merged[dst] = merged.get(dst, 0.0) + (1.0 - alpha) * s
        ranked = sorted(merged.items(), key=lambda t: (-t[1], t[0]))[:k]
        if ranked:
            out[src] = ranked
    return out


class AssistanceService:
    """Real-time engine + background engine + interpolating frontend.

    Both engines consume the *same* hoses (and therefore the same durable
    firehose log), each under its own cadence authority — which is what
    makes the whole service restartable: ``streaming.replay.recover_service``
    restores each engine from its own snapshot chain and replays the shared
    log tail per engine (``rt`` from its offset at the rt cadences, ``bg``
    from its offset at the bg cadences), then rebuilds this cache.
    Recovery hands over both restored engines (``rt`` and ``bg``).

    With ``slo`` set (a ``streaming.overload.SLOConfig``), ``step`` routes
    through an :class:`~repro_torch.streaming.overload.OverloadController`:
    lag-adaptive micro-batching over ``step_many`` plus the degradation
    ladder (shed rt ranking -> stretch bg ranking -> admission-control
    ingest), every shed counted. ``mirrors`` are extra follower rt engines
    fed the same flushed stacks (replica failover), each holding its own
    state.

    Engines made here live on ``device``: CUDA unless the caller names
    another, raising where CUDA is asked for and absent.
    """

    def __init__(self, rt_cfg: Optional[EngineConfig] = None,
                 bg_cfg: Optional[EngineConfig] = None,
                 rt: Optional[SearchAssistanceEngine] = None,
                 bg: Optional[SearchAssistanceEngine] = None,
                 device=None, slo=None, mirrors=()):
        if rt is not None and bg is not None:
            self.rt, self.bg = rt, bg
        elif rt is None and bg is None and rt_cfg is not None:
            device = resolve_device(device)
            self.rt = SearchAssistanceEngine(rt_cfg, name="rt", device=device)
            self.bg = SearchAssistanceEngine(
                bg_cfg or background_config(rt_cfg), name="bg", device=device)
        else:
            raise ValueError("AssistanceService takes rt_cfg, or both the "
                             "rt and bg engines")
        self._cache: Dict[int, List[Tuple[int, float]]] = {}
        self.overload = None
        if slo is not None:
            # late: streaming imports this module (recover_service)
            from ..streaming.overload import OverloadController
            self.overload = OverloadController(self, slo, mirrors=mirrors)

    def step(self, query_events=None, tweets=None, *, log_append=None,
             lag_hint: float = 0.0) -> Optional[Dict]:
        """Feed one tick to both engines; returns the per-engine rank-cycle
        stats (``{"rt": ..., "bg": ...}``) when either engine ranked.

        ``log_append(tick, events, tweets)`` is called BEFORE ingestion in
        both paths (durability precedes state mutation — under overload
        control it receives the admission-controlled batch, which is what
        makes mid-shed crash recovery bit-exact). ``lag_hint`` is the
        caller's external backlog estimate in ticks (arrival tick minus
        ingested tick under simulated pacing); the overload controller
        max-combines it with its own buffer backlog.
        """
        if self.overload is not None:
            return self.overload.offer(query_events, tweets,
                                       log_append=log_append,
                                       lag_hint=lag_hint)
        if log_append is not None:
            log_append(int(self.rt.state.tick), query_events, tweets)
        r1 = self.rt.step(query_events, tweets)
        r2 = self.bg.step(query_events, tweets)
        if r1 is not None or r2 is not None:
            self.refresh_cache()
            return {"rt": r1, "bg": r2}
        return None

    def drain(self) -> Optional[Dict]:
        """Flush any ticks the overload micro-batcher still buffers (no-op
        without overload control)."""
        if self.overload is not None:
            return self.overload.drain()
        return None

    def refresh_cache(self) -> None:
        self._cache = interpolate(self.rt.suggestions, self.bg.suggestions)

    @property
    def suggestions(self) -> Dict[int, List[Tuple[int, float]]]:
        """The interpolated suggestion table the frontend serves."""
        return self._cache

    def suggest_fp(self, fp: int, k: int = 8) -> List[Tuple[int, float]]:
        return self._cache.get(int(fp), [])[:k]

    # ---- persistence: the whole stack snapshots, not just the rt half ----
    def save_snapshot(self, rt_ckpt, bg_ckpt,
                      extra_meta: Optional[Dict] = None) -> Tuple[str, str]:
        """Snapshot BOTH engines (each = checkpoint + its log offset).

        Each manager may be delta-chained (``CheckpointManager.full_interval
        > 1``): the bg engine's slow-moving long-horizon state is where
        delta snapshots pay off most — few slots change per interval, so
        the chain lets the snapshot cadence shrink without a write-volume
        blowup, and the replay tail (time-to-fresh) shrinks with it.

        Under overload control the controller's stats ride along in the
        meta (``overload`` key) so frontends can surface the degradation
        level and shed counters of the backend that produced the tables.
        """
        if self.overload is not None:
            extra_meta = dict(extra_meta or {})
            extra_meta.setdefault("overload",
                                  self.overload.stats_snapshot())
        return (self.rt.save_snapshot(rt_ckpt, extra_meta),
                self.bg.save_snapshot(bg_ckpt, extra_meta))

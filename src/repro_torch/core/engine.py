"""The search assistance engine (paper §4.2–§4.3).

Port of the JAX package's ``core/engine.py``. Per tick: the query path
updates the query store, the sessions store and the cooccurrence store;
the tweet path feeds query-like n-grams through the same stores; decay or
prune cycles and ranking cycles run at their tick cadences.

Differences from the JAX engine, all deliberate:

  * functions run eagerly on tensors of the engine's device; ``ingest_many``
    is a Python loop over ticks instead of a ``lax.scan``;
  * on CUDA every kernel site (the decay sweep, the score/gate pass, the
    per-bucket top-k, and under the region layout the chain find and the
    fused region pass) always runs its hand-written kernel, and on the CPU
    its plain twin, so ``EngineConfig`` has no ``use_kernel`` and no
    ``plan``: a tuned plan routes nothing here, and ``ingest_queries`` runs
    once a quantum slice. ``launch/autotune``'s plan is provenance, which
    ``serve_assist --autotune`` writes into persisted meta.

``state_arrays()``/``load_state_arrays()`` produce and accept exactly the
JAX engine's dict (``leaf_0 .. leaf_25`` under the hash layout,
``leaf_0 .. leaf_26`` under the region layout, in ``jax.tree.flatten``
order, JAX dtypes), which is how JAX state becomes port state and back.
``save_snapshot``/``restore_from_snapshot`` write and read the same leaves
through ``distributed.fault_tolerance.CheckpointManager`` in the JAX
package's on-disk format, so a snapshot of either engine restores in the
other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import ranking, stores
from .decay import (DecayConfig, prune_sweep, region_decay_sweep,
                    region_prune_sweep, sweep_decay_prune)
from .hashing import combine_fp_device, from_np_u32, split_fp, to_np_u32
from .plan import default_region_width
from .ranking import RankConfig
from .stores import U32, HashTable, RegionTable, SessionTable


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # store capacities (powers of two)
    query_capacity: int = 1 << 16
    cooc_capacity: int = 1 << 18
    session_capacity: int = 1 << 15
    session_window: int = 5
    probe_rounds: int = 16
    # source weighting (paper §4.2: typed > related click > hashtag click)
    source_weights: Tuple[float, ...] = (1.0, 0.5, 0.7)
    tweet_weight: float = 0.25
    min_querylike_count: float = 3.0   # tweet n-gram must be a real query
    max_tweet_grams: int = 16
    # cycles (in ticks; a tick is one micro-batch ~ cfg.tick_seconds of data)
    decay_every: int = 6
    rank_every: int = 30
    # lazy decay policy only: the prune-only sweep's cadence
    prune_every: int = 24
    session_ttl: int = 360
    decay: DecayConfig = DecayConfig()
    rank: RankConfig = RankConfig()
    # query micro-batches larger than this are ingested as sequential
    # quantum-sized slices (semantic: the cut points decide the result).
    # 0 disables slicing.
    ingest_quantum: int = 4096
    # cooccurrence-store layout: "hash" = open addressing keyed by the pair
    # fingerprint; "region" = source-major regions chained through a
    # directory indexed by qstore slot (stores.RegionTable).
    cooc_layout: str = "hash"
    # pairs per region; None derives it from cooc_capacity
    # (plan.default_region_width; read it through ``region_w``).
    region_width: Optional[int] = None
    region_chain: int = 8              # max spill-chain regions per source

    def __post_init__(self):
        if self.cooc_layout not in ("hash", "region"):
            raise ValueError(f"unknown cooc_layout {self.cooc_layout!r} "
                             f"(expected 'hash' or 'region')")

    @property
    def lazy_decay(self) -> bool:
        return self.decay.policy == "lazy"

    @property
    def region_cooc(self) -> bool:
        return self.cooc_layout == "region"

    @property
    def region_w(self) -> int:
        """Effective region width (explicit, or derived from capacity)."""
        if self.region_width is not None:
            return self.region_width
        return default_region_width(self.cooc_capacity)


class EngineState(NamedTuple):
    qstore: HashTable
    cooc: Union[HashTable, RegionTable]
    sessions: SessionTable
    tick: torch.Tensor  # i32[]


_QSTORE_LANES = {"weight": torch.float32, "count": torch.float32,
                 "last_tick": torch.int32}
_COOC_LANES = {"weight": torch.float32, "count": torch.float32,
               "last_tick": torch.int32, "src_hi": U32, "src_lo": U32,
               "dst_hi": U32, "dst_lo": U32}


def make_cooc_store(cfg: EngineConfig, capacity: Optional[int] = None,
                    device="cuda"):
    """The cooccurrence store under ``cfg.cooc_layout`` (on CUDA unless
    ``device`` names another device; raises where CUDA is absent).
    ``capacity`` overrides ``cfg.cooc_capacity`` (the sharded engine
    divides it among its shards)."""
    cap = capacity if capacity is not None else cfg.cooc_capacity
    if cfg.region_cooc:
        return stores.make_region_table(
            cap, cfg.region_w, cfg.query_capacity, cfg.region_chain,
            _QSTORE_LANES, device)
    return stores.make_table(cap, _COOC_LANES, device)


def init_state(cfg: EngineConfig, device="cuda") -> EngineState:
    """Empty engine state on ``device`` (CUDA by default; raises where CUDA
    is absent, so pass ``"cpu"`` to run the plain versions)."""
    device = stores.resolve_device(device)
    return EngineState(
        stores.make_table(cfg.query_capacity, _QSTORE_LANES, device),
        make_cooc_store(cfg, device=device),
        stores.make_session_table(cfg.session_capacity, cfg.session_window,
                                  device),
        torch.zeros((), dtype=torch.int32, device=device))


_Q_MODES = (("weight", "add"), ("count", "add"), ("last_tick", "set"))
_C_MODES = (("weight", "add"), ("count", "add"), ("last_tick", "set"),
            ("src_hi", "set"), ("src_lo", "set"),
            ("dst_hi", "set"), ("dst_lo", "set"))


def _source_weights(cfg: EngineConfig, code: torch.Tensor) -> torch.Tensor:
    sw = torch.tensor(cfg.source_weights, dtype=torch.float32,
                      device=code.device)
    return sw[torch.clamp(code, 0, len(cfg.source_weights) - 1).long()]


def _lazy_kw(state: EngineState, cfg: EngineConfig) -> dict:
    """Lazy policy: rebase-on-write so refreshing last_tick never un-decays."""
    return dict(decay_cfg=cfg.decay, now=state.tick) if cfg.lazy_decay else {}


def cooc_insert_pairs(cooc, qstore: HashTable, src_hi, src_lo, dst_hi,
                      dst_lo, w_pair, valid, tick, cfg: EngineConfig, dkw):
    """Layout dispatch for one micro-batch of (src -> dst) pair updates,
    shared by the query path and the tweet path. The hash layout keys them
    by the combined pair fingerprint; the region layout by the source's
    slot in ``qstore`` and the dst fingerprint."""
    P = src_hi.shape[0]
    dev = src_hi.device
    upd = {"weight": w_pair,
           "count": torch.ones((P,), dtype=torch.float32, device=dev),
           "last_tick": torch.as_tensor(tick, dtype=torch.int32,
                                        device=dev).expand(P)}
    if cfg.region_cooc:
        return stores.region_insert_accumulate(
            cooc, qstore, src_hi, src_lo, dst_hi, dst_lo, upd, valid,
            modes=_Q_MODES, probe_rounds=cfg.probe_rounds, **dkw)
    p_hi, p_lo = combine_fp_device(src_hi, src_lo, dst_hi, dst_lo)
    upd.update({"src_hi": src_hi, "src_lo": src_lo,
                "dst_hi": dst_hi, "dst_lo": dst_lo})
    return stores.insert_accumulate(
        cooc, p_hi, p_lo, upd, valid, modes=_C_MODES,
        probe_rounds=cfg.probe_rounds, **dkw)


def ingest_queries(state: EngineState, sess_hi, sess_lo, q_hi, q_lo, src,
                   valid, *, cfg: EngineConfig) -> EngineState:
    """The query path of §4.3 for one micro-batch."""
    B = q_hi.shape[0]
    dev = q_hi.device
    w = _source_weights(cfg, src)
    dkw = _lazy_kw(state, cfg)
    qstore = stores.insert_accumulate(
        state.qstore, q_hi, q_lo,
        {"weight": w, "count": torch.ones((B,), dtype=torch.float32, device=dev),
         "last_tick": state.tick.expand(B)},
        valid, modes=_Q_MODES, probe_rounds=cfg.probe_rounds, **dkw)
    sessions, pairs = stores.update_sessions(
        state.sessions, sess_hi, sess_lo, q_hi, q_lo, src, state.tick, valid,
        probe_rounds=cfg.probe_rounds)
    # pair weight: geometric mean of the two interaction-source weights
    w_pair = torch.sqrt(_source_weights(cfg, pairs.src_code)
                        * _source_weights(cfg, pairs.dst_code))
    cooc = cooc_insert_pairs(state.cooc, qstore, pairs.src_hi, pairs.src_lo,
                             pairs.dst_hi, pairs.dst_lo, w_pair, pairs.valid,
                             state.tick, cfg, dkw)
    return EngineState(qstore, cooc, sessions, state.tick)


def quantum_slices(B: int, quantum: int) -> List[Tuple[int, int]]:
    """Where an oversized query micro-batch is cut: depends only on
    (B, quantum), so live stepping and replay ingest identical slices."""
    if quantum <= 0 or B <= quantum:
        return [(0, B)]
    return [(off, min(off + quantum, B)) for off in range(0, B, quantum)]


def ingest_tweets(state: EngineState, g_hi, g_lo, valid, *,
                  cfg: EngineConfig) -> EngineState:
    """The tweet path of §4.3 for one micro-batch of tweets ([T, G] grams)."""
    T, G = g_hi.shape
    dev = g_hi.device
    flat_hi, flat_lo = g_hi.reshape(-1), g_lo.reshape(-1)
    vals, found, _ = stores.lookup(state.qstore, flat_hi, flat_lo,
                                   probe_rounds=cfg.probe_rounds)
    querylike = (found & (vals["count"] >= cfg.min_querylike_count)
                 & valid[:, None].expand(T, G).reshape(-1))
    B = T * G
    dkw = _lazy_kw(state, cfg)
    qstore = stores.insert_accumulate(
        state.qstore, flat_hi, flat_lo,
        {"weight": torch.full((B,), cfg.tweet_weight, dtype=torch.float32,
                              device=dev),
         "count": torch.ones((B,), dtype=torch.float32, device=dev),
         "last_tick": state.tick.expand(B)},
        querylike, modes=_Q_MODES, probe_rounds=cfg.probe_rounds, **dkw)

    # all ordered pairs among query-like grams of the same tweet
    ql = querylike.reshape(T, G)
    src_hi = g_hi[:, :, None].expand(T, G, G).reshape(-1)
    src_lo = g_lo[:, :, None].expand(T, G, G).reshape(-1)
    dst_hi = g_hi[:, None, :].expand(T, G, G).reshape(-1)
    dst_lo = g_lo[:, None, :].expand(T, G, G).reshape(-1)
    ok = (ql[:, :, None] & ql[:, None, :]).reshape(-1)
    ok = ok & ~((src_hi == dst_hi) & (src_lo == dst_lo))
    P = src_hi.shape[0]
    cooc = cooc_insert_pairs(
        state.cooc, qstore, src_hi, src_lo, dst_hi, dst_lo,
        torch.full((P,), cfg.tweet_weight, dtype=torch.float32, device=dev),
        ok, state.tick, cfg, dkw)
    return EngineState(qstore, cooc, state.sessions, state.tick)


def decay_cycle(state: EngineState, dticks, *, cfg: EngineConfig
                ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
    """Decay/prune cycle (§4.3) of the eager "sweep" policy: decay all
    weights, prune small entries and stale sessions."""
    qstore, q_live, q_tot = sweep_decay_prune(
        state.qstore, dticks, cfg=cfg.decay, weight_lanes=("weight",))
    stats = {"q_live": q_live, "q_total_w": q_tot}
    if cfg.region_cooc:
        # region maintenance validates chains against the swept qstore, so
        # chains of just-pruned sources free at once.
        cooc, c_live, c_tot, c_rec = region_decay_sweep(
            state.cooc, qstore, dticks, cfg=cfg.decay)
        stats["c_reclaimed"] = c_rec
        stats["c_free_regions"] = cooc.free_regions()
    else:
        cooc, c_live, c_tot = sweep_decay_prune(
            state.cooc, dticks, cfg=cfg.decay, weight_lanes=("weight",))
    sessions = stores.evict_sessions(state.sessions, state.tick,
                                     cfg.session_ttl)
    stats.update({"c_live": c_live, "c_total_w": c_tot})
    return EngineState(qstore, cooc, sessions, state.tick), stats


def evict_sessions_cycle(state: EngineState, *, cfg: EngineConfig
                         ) -> EngineState:
    """Session-TTL eviction alone (the lazy policy's ``decay_every`` job)."""
    return state._replace(sessions=stores.evict_sessions(
        state.sessions, state.tick, cfg.session_ttl))


def prune_cycle(state: EngineState, *, cfg: EngineConfig
                ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
    """Lazy policy's slow-cadence maintenance: prune-only sweeps of both
    stores plus session eviction, every ``prune_every`` ticks."""
    qstore, q_live, q_tot, q_rec = prune_sweep(state.qstore, state.tick,
                                               cfg=cfg.decay)
    if cfg.region_cooc:
        cooc, c_live, c_tot, c_rec = region_prune_sweep(
            state.cooc, qstore, state.tick, cfg=cfg.decay)
    else:
        cooc, c_live, c_tot, c_rec = prune_sweep(state.cooc, state.tick,
                                                 cfg=cfg.decay)
    sessions = stores.evict_sessions(state.sessions, state.tick,
                                     cfg.session_ttl)
    stats = {"q_live": q_live, "q_total_w": q_tot,
             "c_live": c_live, "c_total_w": c_tot,
             "q_reclaimed": q_rec, "c_reclaimed": c_rec}
    if cfg.region_cooc:
        stats["c_free_regions"] = cooc.free_regions()
    return EngineState(qstore, cooc, sessions, state.tick), stats


def advance_tick(state: EngineState) -> EngineState:
    return state._replace(tick=state.tick + 1)


class TickStack(NamedTuple):
    """A stack of R consecutive micro-batches (leading dim = tick): query
    lanes [R, B] (B may be 0), tweet grams [R, T, G] with valid [R, T]."""
    sess_hi: torch.Tensor
    sess_lo: torch.Tensor
    q_hi: torch.Tensor
    q_lo: torch.Tensor
    src: torch.Tensor
    q_valid: torch.Tensor
    g_hi: torch.Tensor
    g_lo: torch.Tensor
    t_valid: torch.Tensor

    @property
    def n_ticks(self) -> int:
        return self.sess_hi.shape[0]


def rank_due(cfg: EngineConfig, tick: int) -> bool:
    """Is a ranking cycle due at ``tick``?"""
    return cfg.rank_every > 0 and tick > 0 and tick % cfg.rank_every == 0


def cadence_due(cfg: EngineConfig, tick: int) -> Optional[str]:
    """Which maintenance cycle is due at ``tick``: lazy policy "prune" at
    ``prune_every`` wins over "evict" at ``decay_every``; eager policy
    "decay" at ``decay_every``."""
    if tick <= 0:
        return None
    if cfg.lazy_decay:
        if cfg.prune_every > 0 and tick % cfg.prune_every == 0:
            return "prune"
        if cfg.decay_every > 0 and tick % cfg.decay_every == 0:
            return "evict"
        return None
    if cfg.decay_every > 0 and tick % cfg.decay_every == 0:
        return "decay"
    return None


def maintenance_cadence(state, tick, cfg: EngineConfig, prune_fn, evict_fn,
                        decay_fn):
    """Run the branch :func:`cadence_due` names at ``tick`` (an int or a
    0-d tensor) on ``state`` and return what it returns; ``state`` as it
    was when no cycle is due. The dispatch shared by the unsharded and the
    sharded engines (the JAX package's traced twin of the same name), so
    one statement of the cadence serves both."""
    due = cadence_due(cfg, int(tick))
    fn = {"prune": prune_fn, "evict": evict_fn, "decay": decay_fn}.get(due)
    return state if fn is None else fn(state)


def tick_maintenance(state: EngineState, cfg: EngineConfig,
                     tick: int) -> Tuple[EngineState, Optional[str], dict]:
    """Run the maintenance cycle due at ``tick`` (if any): the one
    statement of it, shared by ``step`` and ``ingest_many``. Returns
    (state, cycle name or None, stats)."""
    stats: dict = {}

    def keep_stats(cycle):
        def fn(s):
            s, st = cycle(s)
            stats.update(st)
            return s
        return fn

    # prune_cycle evicts sessions itself
    state = maintenance_cadence(
        state, tick, cfg,
        prune_fn=keep_stats(lambda s: prune_cycle(s, cfg=cfg)),
        evict_fn=lambda s: evict_sessions_cycle(s, cfg=cfg),
        decay_fn=keep_stats(lambda s: decay_cycle(s, cfg.decay_every,
                                                  cfg=cfg)))
    return state, cadence_due(cfg, tick), stats


def ingest_many(state: EngineState, stack: TickStack, *, cfg: EngineConfig
                ) -> EngineState:
    """Ingest R logged ticks: per tick exactly what one live ``step()`` does
    to the state (query path in quantum slices, tweet path, maintenance,
    tick advance); ranking is left to the caller."""
    have_q = stack.q_hi.shape[1] > 0
    have_t = stack.g_hi.shape[1] > 0 and stack.g_hi.shape[2] > 0
    tick = int(state.tick)
    for i in range(stack.n_ticks):
        if have_q:
            for lo, hi in quantum_slices(stack.q_hi.shape[1],
                                         cfg.ingest_quantum):
                state = ingest_queries(
                    state, stack.sess_hi[i, lo:hi], stack.sess_lo[i, lo:hi],
                    stack.q_hi[i, lo:hi], stack.q_lo[i, lo:hi],
                    stack.src[i, lo:hi], stack.q_valid[i, lo:hi], cfg=cfg)
        if have_t:
            state = ingest_tweets(state, stack.g_hi[i], stack.g_lo[i],
                                  stack.t_valid[i], cfg=cfg)
        state, _, _ = tick_maintenance(state, cfg, tick)
        state = advance_tick(state)
        tick += 1
    return state


def table_leaves(t: Union[HashTable, RegionTable]
                 ) -> List[Tuple[torch.Tensor, bool]]:
    """(tensor, holds_u32) of one store in ``jax.tree.flatten`` order:
    NamedTuple fields in order, the ``lanes`` dict by sorted key."""
    out = [(t.key_hi, True), (t.key_lo, True)]
    out += [(t.lanes[n], n in stores.U32_LANES) for n in sorted(t.lanes)]
    if isinstance(t, RegionTable):
        out += [(t.chain_region, False), (t.chain_hi, True),
                (t.chain_lo, True), (t.region_fill, False),
                (t.region_owner, False)]
    out.append((t.n_dropped, False))
    return out


def session_leaves(s: SessionTable) -> List[Tuple[torch.Tensor, bool]]:
    """(tensor, holds_u32) of a sessions store in ``jax.tree.flatten``
    order."""
    return [(s.key_hi, True), (s.key_lo, True), (s.ring_hi, True),
            (s.ring_lo, True), (s.ring_src, False), (s.cursor, False),
            (s.filled, False), (s.last_tick, False), (s.n_dropped, False)]


def table_from_leaves(t: Union[HashTable, RegionTable], it):
    """A store shaped like ``t`` from the next of iterator ``it``'s tensors
    (inverse of :func:`table_leaves`)."""
    kh, kl = next(it), next(it)
    lanes = {n: next(it) for n in sorted(t.lanes)}
    if isinstance(t, RegionTable):
        return RegionTable(kh, kl, lanes, *(next(it) for _ in range(6)))
    return HashTable(kh, kl, lanes, next(it))


def _flat_leaves(state: EngineState) -> List[Tuple[torch.Tensor, bool]]:
    """(tensor, holds_u32) of the state in ``jax.tree.flatten`` order."""
    return (table_leaves(state.qstore) + table_leaves(state.cooc)
            + session_leaves(state.sessions) + [(state.tick, False)])


def clone_state(state: EngineState) -> EngineState:
    """A copy of ``state`` that shares no storage with it. The stores write
    their tensors in place, so two engines must never step one state."""
    return _unflatten(state, [t.clone() for t, _ in _flat_leaves(state)])


def _snapshot_leaves(state: EngineState) -> List[torch.Tensor]:
    """The state's leaves in ``_flat_leaves`` order, u32 lanes viewed as
    ``torch.uint32`` so a checkpoint stores them as ``uint32``."""
    return [t.view(torch.uint32) if is_u32 else t
            for t, is_u32 in _flat_leaves(state)]


def restore_state(ckpt, template: EngineState, step: Optional[int] = None
                  ) -> Tuple[EngineState, int]:
    """Restore a ``CheckpointManager`` snapshot into an ``EngineState``
    shaped, typed and placed like ``template`` (u32 lanes come back as
    their int32 views). Returns ``(state, restored_step)``: the step is
    the one actually restored, older than asked when a torn member forced
    the manager's fallback. The one path from a snapshot to engine state,
    shared by ``restore_from_snapshot`` and the compaction tier."""
    leaves, step = ckpt.restore(_snapshot_leaves(template), step)
    return _unflatten(template, [
        x.view(torch.int32) if x.dtype == torch.uint32 else x
        for x in leaves]), step


def _unflatten(state: EngineState, leaves: List[torch.Tensor]) -> EngineState:
    it = iter(leaves)
    q = table_from_leaves(state.qstore, it)
    c = table_from_leaves(state.cooc, it)
    sessions = SessionTable(*(next(it) for _ in SessionTable._fields))
    return EngineState(q, c, sessions, next(it))


class SearchAssistanceEngine:
    """Host-side driver of one backend instance (paper Figure 4).

    Call :meth:`step` once per tick with the tick's micro-batches; the
    engine runs decay and ranking cycles at their cadences and keeps the
    latest suggestion table for the frontend. ``device`` defaults to
    ``"cuda"`` and raises where CUDA is absent; pass ``"cpu"`` to run the
    plain versions on the CPU.
    """

    def __init__(self, cfg: EngineConfig, name: str = "rt", device=None):
        device = stores.resolve_device(device)
        self.cfg = cfg
        self.name = name
        self.device = device
        self.state = init_state(cfg, device)
        self.suggestions: Dict[int, List[Tuple[int, float]]] = {}
        self.last_rank_tick: int = -1
        self.n_rank_cycles = 0
        self.n_decay_cycles = 0
        self.n_prune_cycles = 0
        self.last_maintenance: Dict[str, float] = {}

    def _u32(self, a) -> torch.Tensor:
        return from_np_u32(a, self.device)

    # ---- ingestion ----
    def step(self, query_events=None, tweets=None) -> Optional[Dict]:
        """Process one tick. Returns rank-cycle stats when a cycle ran."""
        out = None
        if query_events is not None:
            s_hi, s_lo = split_fp(query_events.sess_fp)
            q_hi, q_lo = split_fp(query_events.q_fp)
            self._ingest_query_batch(
                self._u32(s_hi), self._u32(s_lo),
                self._u32(q_hi), self._u32(q_lo),
                torch.tensor(np.asarray(query_events.src, np.int32),
                             device=self.device),
                torch.tensor(np.asarray(query_events.valid, bool),
                             device=self.device))
        if tweets is not None:
            g_hi, g_lo = split_fp(tweets.grams)
            self.state = ingest_tweets(
                self.state, self._u32(g_hi), self._u32(g_lo),
                torch.tensor(np.asarray(tweets.valid, bool),
                             device=self.device), cfg=self.cfg)

        tick = int(self.state.tick)
        self.state, due, stats = tick_maintenance(self.state, self.cfg, tick)
        if due == "prune":
            self.n_prune_cycles += 1
        elif due == "decay":
            self.n_decay_cycles += 1
        if stats:
            self.last_maintenance = {k: float(v) for k, v in stats.items()}
        if rank_due(self.cfg, tick):
            out = self.run_rank_cycle()
        self.state = advance_tick(self.state)
        return out

    def _ingest_query_batch(self, *arrs) -> None:
        """Cut the batch at the shared :func:`quantum_slices` boundaries."""
        for lo, hi in quantum_slices(arrs[2].shape[0], self.cfg.ingest_quantum):
            self.state = ingest_queries(self.state, *(a[lo:hi] for a in arrs),
                                        cfg=self.cfg)

    def run_rank_cycle(self) -> Dict:
        dkw = (dict(decay_cfg=self.cfg.decay, now=self.state.tick)
               if self.cfg.lazy_decay else {})
        cycle = (ranking.ranking_cycle_region if self.cfg.region_cooc
                 else ranking.ranking_cycle)
        table = cycle(self.state.cooc, self.state.qstore, self.cfg.rank,
                      **dkw)
        self.suggestions = ranking.suggestions_to_host(table)
        self.last_rank_tick = int(self.state.tick)
        self.n_rank_cycles += 1
        return {"tick": self.last_rank_tick,
                "n_rows": int(table.n_rows),
                "n_overflow": int(table.n_overflow),
                "n_suggest": len(self.suggestions)}

    def step_many(self, stack: TickStack) -> None:
        """Multi-tick ingestion (catch-up replay / bulk live ingest); keeps
        the cycle counters consistent with the equivalent ``step()`` loop.
        Ranking cycles are not run."""
        t0 = int(self.state.tick)
        self.state = ingest_many(self.state, stack, cfg=self.cfg)
        due = [cadence_due(self.cfg, t) for t in range(t0, int(self.state.tick))]
        self.n_prune_cycles += sum(d == "prune" for d in due)
        self.n_decay_cycles += sum(d == "decay" for d in due)

    # ---- serving-side reads ----
    def suggest_fp(self, fp: int, k: int = 8) -> List[Tuple[int, float]]:
        return self.suggestions.get(int(fp), [])[:k]

    # ---- persistence (every rank cycle the leader persists, §4.2) ----
    def save_snapshot(self, ckpt, extra_meta: Optional[Dict] = None) -> str:
        """Snapshot = checkpoint + log offset (§4.2 rewind/catch-up).

        The manifest's meta records ``log_tick`` (the first tick a restarted
        instance replays from the firehose log), ``engine``, ``layout`` and
        the last maintenance stats. Whether the manager writes a full or a
        delta against the previous snapshot is its decision
        (``CheckpointManager.full_interval``). The port has no
        ``EngineConfig.plan``; a caller that holds a tuned plan passes it
        as ``extra_meta={"plan": plan.to_json()}``, the key a JAX restore
        adopts.
        """
        tick = int(self.state.tick)
        meta = {"log_tick": tick, "engine": self.name,
                "layout": self.cfg.cooc_layout}
        if self.last_maintenance:
            meta["maintenance"] = self.last_maintenance
        if extra_meta:
            meta.update(extra_meta)
        return ckpt.save(tick, _snapshot_leaves(self.state), meta=meta)

    @classmethod
    def restore_from_snapshot(cls, cfg: EngineConfig, ckpt,
                              step: Optional[int] = None, name: str = "rt",
                              device=None
                              ) -> Tuple["SearchAssistanceEngine", int]:
        """Cold-start from the newest (or a given) snapshot, on ``device``
        (CUDA unless named).

        Returns ``(engine, log_tick)``: ``log_tick`` is the offset to
        resume replaying the firehose log from. The restore walks the
        snapshot's delta chain; when a torn or corrupt member forces the
        fallback to an older intact full (``ckpt.last_restore``), it is
        that snapshot's offset. A JAX snapshot's ``plan`` meta stays in its
        manifest unused: a plan changes dispatch only, never results, and
        the port dispatches every kernel site to its kernel on CUDA.
        """
        eng = cls(cfg, name, device)
        eng.state, step = restore_state(ckpt, eng.state, step)
        meta = ckpt.manifest(step).get("meta", {})
        return eng, int(meta.get("log_tick", step))

    # ---- state carry-over (the JAX engine's leaf dict) ----
    def state_arrays(self) -> Dict[str, np.ndarray]:
        """``leaf_{i}`` numpy arrays in the JAX engine's order and dtypes
        (u32 lanes as uint32): host copies that nothing else references, as
        the JAX engine's are, so later in-place store writes leave them be
        (``.numpy()`` of a CPU tensor would alias it)."""
        out = {}
        for i, (t, is_u32) in enumerate(_flat_leaves(self.state)):
            a = t.detach().to("cpu", copy=True).numpy()
            out[f"leaf_{i}"] = a.view(np.uint32) if is_u32 else a
        return out

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Load a ``state_arrays()`` dict (from this engine or the JAX one)."""
        leaves = []
        for i, (t, is_u32) in enumerate(_flat_leaves(self.state)):
            a = np.asarray(arrays[f"leaf_{i}"])
            if a.shape != tuple(t.shape):
                raise ValueError(f"leaf_{i}: shape {a.shape}, engine has "
                                 f"{tuple(t.shape)}")
            if is_u32:
                leaves.append(from_np_u32(a, self.device))
            else:
                leaves.append(torch.tensor(
                    a.astype(np.float32 if t.dtype == torch.float32
                             else np.int32), device=self.device))
        self.state = _unflatten(self.state, leaves)

"""The sharded search-assistance engine, on one device.

Port of the JAX package's ``core/sharded_engine.py``. The paper's backend
is replicated but not sharded, and names its memory wall (§4.4): one
instance's memory bounds the cooccurrence store. This engine splits the
store by source query:

  * **query store**: one copy, shared by every shard (the JAX engine
    replicates it and every device computes the same copy), so ranking
    marginals and the region layout's directory slots are global;
  * **sessions store**: one store per shard, owned by session hash, so a
    shard generates the pairs of its own sessions;
  * **cooccurrence store**: one store per shard, owned by source-query
    hash, so one shard holds every pair of its sources and top-k is local;
  * **hot-key salting**: a source whose count in the query store has
    reached ``hot_threshold`` spreads its pairs over ``n_salts`` shards by
    a salt on the destination hash; the host merge takes the per-salt
    top-k lists together;
  * **routing**: fixed-capacity buckets per destination shard; overflow is
    dropped and counted on the source shard's ``n_route_drop``.

Where the JAX engine runs a ``shard_map`` over a mesh axis, this one keeps
one table object per shard on one device and runs the single-device store
and ranking code of the port once per shard; the ``all_to_all`` of the
routing step is a transpose of the ``[source, destination, capacity]``
buckets. Every function takes ``n_shards`` (and ``device``, CUDA unless
named) where the JAX one takes ``mesh`` and ``axis``; each ``make_*``
returns a plain callable with the argument order of the JAX function's
jitted one. The stores update in place, so a state passed to a step is
consumed (:func:`clone_sharded_state` copies one).

:func:`sharded_leaves` lays the state out as the JAX ``ShardedState``
flattens: the query store, then each per-shard store's leaves
concatenated along dim 0 in shard order (per-shard scalars stacked to
``(n,)``), then ``tick`` and ``n_route_drop``. Snapshots, the state-array
dicts of the tests and the reshard's export read these leaves, so a
snapshot of either engine restores in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from . import ranking, stores
from .decay import (prune_sweep, region_decay_sweep, region_prune_sweep,
                    sweep_decay_prune)
from .engine import (_Q_MODES, _QSTORE_LANES, EngineConfig, _source_weights,
                     cooc_insert_pairs, maintenance_cadence, make_cooc_store,
                     session_leaves, table_from_leaves, table_leaves)
from .hashing import (MASK32, combine_fp_device, from_np_u32, join_fp,
                      probe_hash, to_np_u32)
from .ranking import SuggestionTable
from .stores import HashTable, RegionTable, SessionTable


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    base: EngineConfig
    n_salts: int = 4
    hot_threshold: float = 50.0     # count above which a src key is "hot"
    route_capacity: int = 4096      # per-destination bucket capacity


class ShardedState(NamedTuple):
    qstore: HashTable                                # one copy, shared
    cooc: Tuple[Union[HashTable, RegionTable], ...]  # one store per shard
    sessions: Tuple[SessionTable, ...]               # one store per shard
    tick: torch.Tensor                               # i32[]
    n_route_drop: torch.Tensor   # i32[n]: routed pairs dropped on overflow

    @property
    def n_shards(self) -> int:
        return len(self.cooc)


def _as_lane(x, device) -> torch.Tensor:
    """A hose lane on ``device``: a tensor as it is, a numpy uint32 array
    as its int32 bit view, any other array as its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return from_np_u32(a, device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def init_sharded_state(cfg: ShardedConfig, n_shards: int, device="cuda"
                       ) -> ShardedState:
    """An empty sharded state on ``device`` (CUDA unless named). Each shard
    gets ``1/n_shards`` of the cooc and session capacities; under the
    region layout each shard holds its own region pool and a full-Q chain
    directory (slot ids are the shared query store's)."""
    device = stores.resolve_device(device)
    n, base = n_shards, cfg.base
    return ShardedState(
        qstore=stores.make_table(base.query_capacity, _QSTORE_LANES, device),
        cooc=tuple(make_cooc_store(base, capacity=base.cooc_capacity // n,
                                   device=device) for _ in range(n)),
        sessions=tuple(stores.make_session_table(
            base.session_capacity // n, base.session_window, device)
            for _ in range(n)),
        tick=torch.zeros((), dtype=torch.int32, device=device),
        n_route_drop=torch.zeros((n,), dtype=torch.int32, device=device))


def _route(pairs_key_hi, pairs_key_lo, owner, payload: Dict[str, torch.Tensor],
           valid, n_shards: int, cap: int):
    """Bucket every source shard's pairs by owner shard and exchange them.

    Inputs carry a leading source-shard axis (``[n, Bp]``). Per source
    shard: a stable sort by owner, each pair's position within its owner's
    run, and pairs past ``cap`` in a bucket dropped and counted. The
    exchange (the JAX ``all_to_all``) hands destination ``j`` the buckets
    ``b_i[j]`` of every source ``i``, concatenated in source order. Returns
    ``(hi, lo, payload, valid)`` each ``[n, n * cap]`` by destination, and
    the drops ``i32[n]`` by source.
    """
    n, Bp = pairs_key_hi.shape
    dev = pairs_key_hi.device
    owner = torch.where(valid, owner, n_shards)   # invalid -> sentinel run
    order = torch.argsort(owner, dim=1, stable=True)
    o_sorted = torch.gather(owner, 1, order)
    seg_start = torch.searchsorted(
        o_sorted, torch.arange(n_shards + 1, device=dev).expand(n, -1)
        .contiguous())
    pos = (torch.arange(Bp, device=dev)
           - torch.gather(seg_start, 1, torch.clamp(o_sorted, 0, n_shards)))
    routed = o_sorted < n_shards
    ok = routed & (pos < cap)
    dropped = (routed & (pos >= cap)).sum(1, dtype=torch.int32)
    src_i, col = ok.nonzero(as_tuple=True)
    dst_j, dpos = o_sorted[src_i, col], pos[src_i, col]
    take = order[src_i, col]

    def exchange(x, fill=0):
        buf = torch.full((n_shards, n_shards, cap), fill, dtype=x.dtype,
                         device=dev)
        buf[dst_j, src_i, dpos] = x[src_i, take]
        return buf.reshape(n_shards, n_shards * cap)

    return (exchange(pairs_key_hi), exchange(pairs_key_lo),
            {k: exchange(v) for k, v in payload.items()},
            exchange(ok.new_ones(ok.shape), False), dropped)


def _ingest(cfg: ShardedConfig, state: ShardedState, s_hi, s_lo, q_hi, q_lo,
            src, valid) -> ShardedState:
    """The query-path ingest of one micro-batch over every shard (shared by
    the one-tick steps and the multi-tick replay)."""
    base = cfg.base
    n = state.n_shards
    B = q_hi.shape[0]
    dev = q_hi.device
    # lazy decay policy: same rebase-on-write as the unsharded engine
    dkw = (dict(decay_cfg=base.decay, now=state.tick)
           if base.lazy_decay else {})

    # --- the shared query store takes the full batch once ---
    qstore = stores.insert_accumulate(
        state.qstore, q_hi, q_lo,
        {"weight": _source_weights(base, src),
         "count": torch.ones((B,), dtype=torch.float32, device=dev),
         "last_tick": state.tick.expand(B)},
        valid, modes=_Q_MODES, probe_rounds=base.probe_rounds, **dkw)

    # --- sessions: shard i takes the full batch masked to its sessions ---
    sess_owner = probe_hash(s_hi, s_lo) % n
    sessions, batches = [], []
    for i in range(n):
        table, pairs = stores.update_sessions(
            state.sessions[i], s_hi, s_lo, q_hi, q_lo, src, state.tick,
            valid & (sess_owner == i), probe_rounds=base.probe_rounds)
        sessions.append(table)
        batches.append(pairs)
    pairs = stores.PairBatch(*(torch.stack(f) for f in zip(*batches)))

    # --- route pairs to the cooc owner: hash(src) (+ salt if hot) ---
    svals, sfound, _ = stores.lookup(qstore, pairs.src_hi.reshape(-1),
                                     pairs.src_lo.reshape(-1),
                                     probe_rounds=base.probe_rounds)
    hot = (sfound & (svals["count"] >= cfg.hot_threshold)).view(n, -1)
    salt = torch.where(hot, probe_hash(pairs.dst_hi, pairs.dst_lo)
                       % cfg.n_salts, 0)
    # u32 arithmetic: the sum wraps at 2**32 before the modulo
    owner = ((probe_hash(pairs.src_hi, pairs.src_lo) + salt) & MASK32) % n
    w_pair = torch.sqrt(_source_weights(base, pairs.src_code)
                        * _source_weights(base, pairs.dst_code))
    payload = {"src_hi": pairs.src_hi, "src_lo": pairs.src_lo,
               "dst_hi": pairs.dst_hi, "dst_lo": pairs.dst_lo, "w": w_pair}
    _, _, r_pl, r_valid, drop = _route(
        pairs.src_hi, pairs.src_lo, owner, payload, pairs.valid, n,
        cfg.route_capacity)
    cooc = tuple(
        cooc_insert_pairs(state.cooc[j], qstore, r_pl["src_hi"][j],
                          r_pl["src_lo"][j], r_pl["dst_hi"][j],
                          r_pl["dst_lo"][j], r_pl["w"][j], r_valid[j],
                          state.tick, base, dkw) for j in range(n))
    return ShardedState(qstore, cooc, tuple(sessions), state.tick,
                        state.n_route_drop + drop)


def _hose_step(n_shards: int, device, body):
    """A plain callable ``(state, s_hi, s_lo, q_hi, q_lo, src, valid)``
    over ``body``, the lanes moved to ``device`` first."""
    device = stores.resolve_device(device)

    def step(state: ShardedState, *lanes) -> ShardedState:
        if state.n_shards != n_shards:
            raise ValueError(f"the state has {state.n_shards} shards, the "
                             f"step was made for {n_shards}")
        return body(state, *(_as_lane(x, device) for x in lanes))

    return step


def make_sharded_step(cfg: ShardedConfig, n_shards: int, device="cuda"):
    """The sharded ingest step (query path), tick left as it is."""
    return _hose_step(n_shards, device,
                      lambda state, *lanes: _ingest(cfg, state, *lanes))


def _tick_maintenance(state: ShardedState, base: EngineConfig
                      ) -> ShardedState:
    """Per-tick maintenance on the sharded state: the shared
    ``engine.maintenance_cadence`` dispatch with sharded branch bodies
    (the query store swept once, each shard's cooc and sessions). Lazy:
    prune-only sweeps at ``prune_every``, session eviction at
    ``decay_every``; eager: full decay/prune and eviction at
    ``decay_every``. The live tick step and the replay both run it."""

    def evict_only(s: ShardedState) -> ShardedState:
        return s._replace(sessions=tuple(
            stores.evict_sessions(t, s.tick, base.session_ttl)
            for t in s.sessions))

    def prune_fn(s: ShardedState) -> ShardedState:
        qstore = prune_sweep(s.qstore, s.tick, cfg=base.decay)[0]
        if base.region_cooc:
            cooc = tuple(region_prune_sweep(c, qstore, s.tick,
                                            cfg=base.decay)[0]
                         for c in s.cooc)
        else:
            cooc = tuple(prune_sweep(c, s.tick, cfg=base.decay)[0]
                         for c in s.cooc)
        return evict_only(s._replace(qstore=qstore, cooc=cooc))

    def decay_fn(s: ShardedState) -> ShardedState:
        qstore = sweep_decay_prune(s.qstore, base.decay_every,
                                   cfg=base.decay)[0]
        if base.region_cooc:
            cooc = tuple(region_decay_sweep(c, qstore, base.decay_every,
                                            cfg=base.decay)[0]
                         for c in s.cooc)
        else:
            cooc = tuple(sweep_decay_prune(c, base.decay_every,
                                           cfg=base.decay)[0]
                         for c in s.cooc)
        return evict_only(s._replace(qstore=qstore, cooc=cooc))

    return maintenance_cadence(state, state.tick, base, prune_fn=prune_fn,
                               evict_fn=evict_only, decay_fn=decay_fn)


def _full_tick(cfg: ShardedConfig, state: ShardedState, *lanes
               ) -> ShardedState:
    state = _ingest(cfg, state, *lanes)
    state = _tick_maintenance(state, cfg.base)
    return state._replace(tick=state.tick + 1)


def make_sharded_tick_step(cfg: ShardedConfig, n_shards: int,
                           device="cuda"):
    """One full live tick (ingest, cadence maintenance, tick advance): the
    sharded equivalent of ``SearchAssistanceEngine.step``'s state
    mutations, so a run stepped with it replays exactly under
    :func:`make_sharded_ingest_many`."""
    return _hose_step(n_shards, device,
                      lambda state, *lanes: _full_tick(cfg, state, *lanes))


def make_sharded_ingest_many(cfg: ShardedConfig, n_shards: int,
                             device="cuda"):
    """Catch-up replay over the sharded engine (§4.2): every shard reads
    the one shared log, and each logged tick is exactly one live tick
    step. Takes stacked query-hose lanes ``[R, B]``; returns the advanced
    state."""

    def many(state: ShardedState, *lanes) -> ShardedState:
        for r in range(lanes[0].shape[0]):
            state = _full_tick(cfg, state, *(x[r] for x in lanes))
        return state

    return _hose_step(n_shards, device, many)


def make_sharded_decay(cfg: ShardedConfig, n_shards: int, device="cuda"):
    """The decay cycle ``(state, dticks) -> state`` over every shard: the
    eager sweeps (``decay_prune_multi`` on the query store and the hash
    layout's shards), or under the lazy policy the prune-only sweeps (run
    it at the ``prune_every`` cadence), then session eviction."""
    base = cfg.base
    stores.resolve_device(device)

    def decay(state: ShardedState, dticks) -> ShardedState:
        if state.n_shards != n_shards:
            raise ValueError(f"the state has {state.n_shards} shards, the "
                             f"decay was made for {n_shards}")
        if base.lazy_decay:
            qstore = prune_sweep(state.qstore, state.tick, cfg=base.decay)[0]
            if base.region_cooc:
                cooc = tuple(region_prune_sweep(c, qstore, state.tick,
                                                cfg=base.decay)[0]
                             for c in state.cooc)
            else:
                cooc = tuple(prune_sweep(c, state.tick, cfg=base.decay)[0]
                             for c in state.cooc)
        else:
            if not isinstance(dticks, torch.Tensor):
                dticks = int(dticks)
            qstore = sweep_decay_prune(state.qstore, dticks,
                                       cfg=base.decay)[0]
            if base.region_cooc:
                cooc = tuple(region_decay_sweep(c, qstore, dticks,
                                                cfg=base.decay)[0]
                             for c in state.cooc)
            else:
                cooc = tuple(sweep_decay_prune(c, dticks, cfg=base.decay)[0]
                             for c in state.cooc)
        sessions = tuple(stores.evict_sessions(t, state.tick, base.session_ttl)
                         for t in state.sessions)
        return ShardedState(qstore, cooc, sessions, state.tick,
                            state.n_route_drop)

    return decay


def _concat_tables(tables: List[SuggestionTable]) -> SuggestionTable:
    """Per-shard suggestion tables as one: rows concatenated in shard
    order, ``n_rows`` and ``n_overflow`` stacked to ``(n,)``."""
    return SuggestionTable(
        *(torch.cat(f) for f in list(zip(*tables))[:5]),
        n_rows=torch.stack([t.n_rows for t in tables]),
        n_overflow=torch.stack([t.n_overflow for t in tables]))


def make_sharded_rank(cfg: ShardedConfig, n_shards: int, device="cuda"):
    """The ranking cycle ``state -> SuggestionTable`` per shard against the
    shared query store (``ranking_cycle``: ``score_gate`` and
    ``bucket_topk``; ``ranking_cycle_region``: ``region_rank`` and
    ``bucket_topk``), the shards' rows concatenated."""
    base = cfg.base
    stores.resolve_device(device)
    cycle = (ranking.ranking_cycle_region if base.region_cooc
             else ranking.ranking_cycle)

    def rank(state: ShardedState) -> SuggestionTable:
        if state.n_shards != n_shards:
            raise ValueError(f"the state has {state.n_shards} shards, the "
                             f"rank was made for {n_shards}")
        dkw = (dict(decay_cfg=base.decay, now=state.tick)
               if base.lazy_decay else {})
        return _concat_tables([cycle(c, state.qstore, base.rank, **dkw)
                               for c in state.cooc])

    return rank


# ---------------------------------------------------------------------------
# The JAX ShardedState's leaves: snapshots and state-array dicts.
# ---------------------------------------------------------------------------

def _stack(parts: List[torch.Tensor]) -> torch.Tensor:
    """Per-shard copies of one leaf in the JAX layout: scalars stacked to
    ``(n,)``, arrays concatenated along dim 0."""
    return torch.stack(parts) if parts[0].dim() == 0 else torch.cat(parts)


def sharded_leaves(state: ShardedState) -> List[Tuple[torch.Tensor, bool]]:
    """(tensor, holds_u32) in ``jax.tree.flatten(ShardedState)`` order with
    JAX's global shapes. The per-shard leaves are new tensors; the query
    store's, ``tick``'s and ``n_route_drop``'s are the state's own."""
    out = table_leaves(state.qstore)
    for per_shard in (zip(*map(table_leaves, state.cooc)),
                      zip(*map(session_leaves, state.sessions))):
        out += [(_stack([t for t, _ in leaf]), leaf[0][1])
                for leaf in per_shard]
    return out + [(state.tick, False), (state.n_route_drop, False)]


def _unstack(template: ShardedState, leaves: List[torch.Tensor]
             ) -> ShardedState:
    """A state shaped like ``template`` from leaves in
    :func:`sharded_leaves` order (each shard's part copied out)."""
    n = template.n_shards
    it = iter(leaves)
    qstore = table_from_leaves(template.qstore, it)

    def split(per_shard_template):
        parts = [[] for _ in range(n)]
        for t, _ in per_shard_template:
            x = next(it)
            want = ((n,) if t.dim() == 0
                    else (n * t.shape[0],) + tuple(t.shape[1:]))
            if tuple(x.shape) != want:
                raise ValueError(f"leaf of shape {tuple(x.shape)} for "
                                 f"{n} shards of {tuple(t.shape)}")
            m = x.shape[0] // n
            for i in range(n):
                parts[i].append((x[i] if t.dim() == 0
                                 else x[i * m:(i + 1) * m]).clone())
        return parts

    cooc = tuple(table_from_leaves(template.cooc[0], iter(p))
                 for p in split(table_leaves(template.cooc[0])))
    sessions = tuple(SessionTable(*p)
                     for p in split(session_leaves(template.sessions[0])))
    return ShardedState(qstore, cooc, sessions, next(it), next(it))


def clone_sharded_state(state: ShardedState) -> ShardedState:
    """A copy of ``state`` that shares no storage with it (the stores write
    in place, so two runs must never step one state)."""
    return _unstack(state, [t.clone() for t, _ in sharded_leaves(state)])


def sharded_state_arrays(state: ShardedState) -> Dict[str, np.ndarray]:
    """``leaf_{i}`` host arrays in the JAX ``ShardedState``'s flatten order,
    shapes and dtypes (u32 lanes as uint32)."""
    out = {}
    for i, (t, is_u32) in enumerate(sharded_leaves(state)):
        a = t.detach().to("cpu", copy=True).numpy()
        out[f"leaf_{i}"] = a.view(np.uint32) if is_u32 else a
    return out


def load_sharded_state_arrays(cfg: ShardedConfig, arrays: Dict[str, np.ndarray],
                              n_shards: int, device="cuda") -> ShardedState:
    """A state on ``device`` from a ``sharded_state_arrays()`` dict (of this
    engine or the JAX one's ``jax.tree.flatten`` leaves)."""
    template = init_sharded_state(cfg, n_shards, device)
    leaves = []
    for i, (t, is_u32) in enumerate(sharded_leaves(template)):
        a = np.asarray(arrays[f"leaf_{i}"])
        if a.shape != tuple(t.shape):
            raise ValueError(f"leaf_{i}: shape {a.shape}, state has "
                             f"{tuple(t.shape)}")
        leaves.append(from_np_u32(a, t.device) if is_u32 else
                      torch.from_numpy(np.ascontiguousarray(a)).to(
                          device=t.device, dtype=t.dtype))
    return _unstack(template, leaves)


def _snapshot_leaves(state: ShardedState) -> List[torch.Tensor]:
    return [t.view(torch.uint32) if is_u32 else t
            for t, is_u32 in sharded_leaves(state)]


def save_sharded_snapshot(state: ShardedState, ckpt, meta=None) -> str:
    """Snapshot = checkpoint + log offset for the sharded engine: the whole
    state (every shard's stores) in one ``CheckpointManager`` step, with
    the shared log's replay offset in the manifest. With ``full_interval >
    1`` the manager writes deltas (the changed leading rows of each
    shard-stacked leaf) between fulls; :func:`restore_sharded_snapshot`
    walks the chain."""
    tick = int(state.tick)
    m = {"log_tick": tick, "engine": "sharded"}
    if meta:
        m.update(meta)
    return ckpt.save(tick, _snapshot_leaves(state), meta=m)


def restore_sharded_snapshot(cfg: ShardedConfig, n_shards: int, ckpt,
                             step=None, device="cuda"
                             ) -> Tuple[ShardedState, int]:
    """Cold-start a sharded instance on ``device`` (CUDA unless named):
    returns ``(state, log_tick)``; every shard restores in one pass, then
    all replay the shared log through :func:`make_sharded_ingest_many`."""
    template = init_sharded_state(cfg, n_shards, device)
    leaves, step = ckpt.restore(_snapshot_leaves(template), step)
    state = _unstack(template, [x.view(torch.int32) if x.dtype == torch.uint32
                                else x for x in leaves])
    meta = ckpt.manifest(step).get("meta", {})
    return state, int(meta.get("log_tick", step))


def merge_sharded_suggestions(table: SuggestionTable, top_k: int
                              ) -> Dict[int, List[Tuple[int, float]]]:
    """Host-side merge of per-shard suggestion tables (salted sources
    appear in up to ``n_salts`` shards): per destination the best score,
    then the ``top_k`` best by ``(-score, fp)``."""
    src_hi = to_np_u32(table.src_hi).reshape(-1)
    src_lo = to_np_u32(table.src_lo).reshape(-1)
    K = table.score.shape[-1]
    dst_hi = to_np_u32(table.dst_hi).reshape(-1, K)
    dst_lo = to_np_u32(table.dst_lo).reshape(-1, K)
    score = table.score.cpu().numpy().reshape(-1, K)
    merged: Dict[int, Dict[int, float]] = {}
    # skip empty rows and the lexsort path's all-ones filler src key
    mask = ((src_hi != 0) | (src_lo != 0)) \
        & ~((src_hi == 0xFFFFFFFF) & (src_lo == 0xFFFFFFFF))
    src_fp = join_fp(src_hi, src_lo)
    dst_fp = join_fp(dst_hi, dst_lo)
    for i in np.nonzero(mask)[0]:
        d = merged.setdefault(int(src_fp[i]), {})
        for j in range(K):
            if score[i, j] > 0.0:
                fp = int(dst_fp[i, j])
                d[fp] = max(d.get(fp, 0.0), float(score[i, j]))
    return {s: sorted(d.items(), key=lambda t: (-t[1], t[0]))[:top_k]
            for s, d in merged.items()}


# ---------------------------------------------------------------------------
# Live shard split and merge (elastic scaling).
#
# Re-partitions a running state across another shard count without losing
# state: every live cooccurrence pair and session is exported to a
# canonical host form, duplicates merged (a source that crossed
# hot_threshold mid-run salted its later inserts, so one (src, dst) pair
# can live in several old shards), then re-inserted into fresh per-shard
# stores under the new ownership rule, the one the live ingest path routes
# by. The query store is copied verbatim, which keeps every region
# directory slot id valid. The result is a function of the state's content
# alone: two reshards of equal states give equal new states (see
# distributed.elastic.live_reshard).
# ---------------------------------------------------------------------------

_SET = stores.SET
_SET_PAIR_MODES = (("weight", _SET), ("count", _SET), ("last_tick", _SET))
_SET_HASH_MODES = _SET_PAIR_MODES + (("src_hi", _SET), ("src_lo", _SET),
                                     ("dst_hi", _SET), ("dst_lo", _SET))
_PAIR_COLS = ("src_hi", "src_lo", "dst_hi", "dst_lo",
              "weight", "count", "last_tick")
_SESS_COLS = ("key_hi", "key_lo", "ring_hi", "ring_lo", "ring_src",
              "cursor", "filled", "last_tick")
_U32_COLS = frozenset({"src_hi", "src_lo", "dst_hi", "dst_lo", "key_hi",
                       "key_lo", "ring_hi", "ring_lo"})


def _export_hash_pairs(tab: HashTable) -> Dict[str, np.ndarray]:
    e = stores.export_live(tab)
    return {k: e[k] for k in _PAIR_COLS}


def _export_region_pairs(tab: RegionTable, qstore: HashTable
                         ) -> Dict[str, np.ndarray]:
    """Live pairs of one region-layout shard: the packed region pool under
    the shared chain-validity rule (orphaned chains and stale directory
    rows export nothing, as ranking skips them)."""
    _, _, referenced = stores.region_chain_state(tab, qstore)
    referenced = referenced.cpu().numpy()
    fill = tab.region_fill.cpu().numpy()
    owner = tab.region_owner.cpu().numpy()
    chain_hi, chain_lo = to_np_u32(tab.chain_hi), to_np_u32(tab.chain_lo)
    khi, klo = to_np_u32(tab.key_hi), to_np_u32(tab.key_lo)
    W, C = tab.width, tab.capacity
    slot = np.arange(C)
    reg, pos = slot // W, slot % W
    live = referenced[reg] & (pos < fill[reg]) & ((khi != 0) | (klo != 0))
    idx = np.nonzero(live)[0]
    src_slot = owner[reg[idx]]
    out = {"src_hi": chain_hi[src_slot], "src_lo": chain_lo[src_slot],
           "dst_hi": khi[idx], "dst_lo": klo[idx]}
    for name in ("weight", "count", "last_tick"):
        out[name] = tab.lanes[name].cpu().numpy()[idx]
    return out


def _merge_duplicate_pairs(base: EngineConfig, e: Dict[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
    """Canonical-sort and merge multi-shard duplicates of a (src, dst) pair.

    Under the lazy decay policy the duplicates' (weight, last_tick)
    encodings differ; each weight is rebased to the group's max last_tick
    with the decay formula the device reads use (``base.decay.factor``),
    so the merged entry decays to the same value as the duplicates
    summed."""
    if e["src_hi"].size == 0:
        return e
    order = np.lexsort((e["dst_lo"], e["dst_hi"], e["src_lo"], e["src_hi"]))
    s = {k: v[order] for k, v in e.items()}
    key = np.stack([s["src_hi"], s["src_lo"], s["dst_hi"], s["dst_lo"]], 1)
    new_grp = np.any(key[1:] != key[:-1], axis=1)
    starts = np.concatenate([[0], np.nonzero(new_grp)[0] + 1])
    seg = np.concatenate([[0], np.cumsum(new_grp.astype(np.int64))])
    lt_max = np.maximum.reduceat(s["last_tick"], starts)
    w = s["weight"].astype(np.float32)
    if base.lazy_decay:
        dt = (lt_max[seg] - s["last_tick"]).astype(np.float32)
        f = base.decay.factor(torch.from_numpy(dt)).numpy()
        w = (w * f).astype(np.float32)
    out = {k: s[k][starts] for k in ("src_hi", "src_lo", "dst_hi", "dst_lo")}
    out["weight"] = np.add.reduceat(w, starts).astype(np.float32)
    out["count"] = np.add.reduceat(
        s["count"].astype(np.float32), starts).astype(np.float32)
    out["last_tick"] = lt_max.astype(np.int32)
    return out


def export_sharded_pairs(cfg: ShardedConfig, state: ShardedState
                         ) -> Dict[str, np.ndarray]:
    """All live (src -> dst) pairs across shards, canonical order, merged."""
    parts = [_export_region_pairs(tab, state.qstore) if cfg.base.region_cooc
             else _export_hash_pairs(tab) for tab in state.cooc]
    merged = {k: np.concatenate([p[k] for p in parts]) for k in _PAIR_COLS}
    return _merge_duplicate_pairs(cfg.base, merged)


def export_sharded_sessions(state: ShardedState) -> Dict[str, np.ndarray]:
    """All live sessions across shards, full rows, canonical key order.
    Session ownership is total (one owner per key), so nothing merges."""
    cols: Dict[str, list] = {k: [] for k in _SESS_COLS}
    for t in state.sessions:
        mask = ((t.key_hi != 0) | (t.key_lo != 0)).cpu().numpy()
        for k in _SESS_COLS:
            x = getattr(t, k)
            cols[k].append((to_np_u32(x) if k in _U32_COLS
                            else x.cpu().numpy())[mask])
    e = {k: np.concatenate(v) for k, v in cols.items()}
    order = np.lexsort((e["key_lo"], e["key_hi"]))
    return {k: v[order] for k, v in e.items()}


def _to_device(name: str, a: np.ndarray, device) -> torch.Tensor:
    return (from_np_u32(a, device) if name in _U32_COLS
            else torch.from_numpy(np.ascontiguousarray(a)).to(device))


def _fill_cooc_shard(cfg: ShardedConfig, new_n: int, qstore: HashTable,
                     pairs: Dict[str, np.ndarray], idx: np.ndarray):
    base = cfg.base
    dev = qstore.key_hi.device
    tab = make_cooc_store(base, capacity=base.cooc_capacity // new_n,
                          device=dev)
    if idx.size == 0:
        return tab, 0
    col = {k: _to_device(k, pairs[k][idx], dev) for k in _PAIR_COLS}
    upd = {k: col[k] for k in ("weight", "count", "last_tick")}
    valid = torch.ones((idx.size,), dtype=torch.bool, device=dev)
    # all-SET modes, no decay arguments: the merged (weight, last_tick)
    # pairs are copied bit for bit, which keeps the lazy policy's meaning.
    if base.region_cooc:
        tab = stores.region_insert_accumulate(
            tab, qstore, col["src_hi"], col["src_lo"], col["dst_hi"],
            col["dst_lo"], upd, valid, modes=_SET_PAIR_MODES,
            probe_rounds=base.probe_rounds)
    else:
        p_hi, p_lo = combine_fp_device(col["src_hi"], col["src_lo"],
                                       col["dst_hi"], col["dst_lo"])
        upd.update({k: col[k] for k in ("src_hi", "src_lo", "dst_hi",
                                        "dst_lo")})
        tab = stores.insert_accumulate(
            tab, p_hi, p_lo, upd, valid, modes=_SET_HASH_MODES,
            probe_rounds=base.probe_rounds)
    return tab, int(tab.n_dropped)


def _fill_session_shard(base: EngineConfig, new_n: int,
                        sess: Dict[str, np.ndarray], idx: np.ndarray,
                        device):
    cap = base.session_capacity // new_n
    tab = stores.make_session_table(cap, base.session_window, device)
    if idx.size == 0:
        return tab, 0
    col = {k: _to_device(k, sess[k][idx], device) for k in _SESS_COLS}
    alive = torch.ones((idx.size,), dtype=torch.bool, device=device)
    # probe-consistent placement (later live update_sessions probes must
    # find these rows) and a direct full-row scatter: update_sessions
    # cannot reproduce per-session last_tick (its tick is a scalar), and the
    # ring/cursor/filled triple must carry over verbatim.
    key_hi, key_lo, slot, placed, dropped = stores._find_or_claim(
        tab.key_hi, tab.key_lo, col["key_hi"], col["key_lo"], alive,
        base.probe_rounds)
    rows = placed.nonzero().squeeze(1)
    ws = slot[rows]
    for k in ("ring_hi", "ring_lo", "ring_src", "cursor", "filled",
              "last_tick"):
        getattr(tab, k)[ws] = col[k][rows]
    tab = tab._replace(key_hi=key_hi, key_lo=key_lo,
                       n_dropped=tab.n_dropped + dropped)
    return tab, int(dropped)


def reshard_sharded_state(cfg: ShardedConfig, state: ShardedState,
                          new_n: int) -> Tuple[ShardedState, Dict]:
    """Re-partition a live sharded state across ``new_n`` shards, on the
    state's device.

    Deterministic in the state's content (no RNG, canonical order
    throughout); ``tick`` and the shared query store carry over (copied:
    the new state shares no storage with the old one, which may go on
    serving), so the new state replays the shared log from the same
    offset. Routing hotness is decided again against the current query
    store, as the live ingest path would decide it next tick. Per-shard
    drop counters restart at the insertion drops (the old totals are in
    the stats).
    """
    base = cfg.base
    old_n = state.n_shards
    if new_n < 1 or new_n & (new_n - 1):
        raise ValueError(f"new_n must be a power of two, got {new_n}")
    if base.cooc_capacity % new_n or \
            base.cooc_capacity // new_n < base.region_w:
        raise ValueError("cooc capacity does not divide into new_n "
                         "region-layout shards")
    if base.session_capacity % new_n:
        raise ValueError("session capacity not divisible by new_n")
    dev = state.qstore.key_hi.device

    pairs = export_sharded_pairs(cfg, state)
    sess = export_sharded_sessions(state)

    # ownership under new_n: the rule of the live ingest path
    s_hi, s_lo, d_hi, d_lo = (from_np_u32(pairs[k], dev) for k in
                              ("src_hi", "src_lo", "dst_hi", "dst_lo"))
    svals, sfound, _ = stores.lookup(state.qstore, s_hi, s_lo,
                                     probe_rounds=base.probe_rounds)
    hot = sfound.cpu().numpy() & (svals["count"].cpu().numpy()
                                  >= cfg.hot_threshold)
    salt = np.where(hot, probe_hash(d_hi, d_lo).cpu().numpy()
                    % max(cfg.n_salts, 1), 0).astype(np.uint64)
    owner = ((probe_hash(s_hi, s_lo).cpu().numpy().astype(np.uint64) + salt)
             % new_n).astype(np.int64)
    sess_owner = (probe_hash(from_np_u32(sess["key_hi"], dev),
                             from_np_u32(sess["key_lo"], dev)).cpu().numpy()
                  .astype(np.uint64) % new_n).astype(np.int64)

    qstore = table_from_leaves(state.qstore, iter(
        [t.clone() for t, _ in table_leaves(state.qstore)]))
    coocs, sessions, n_pair_drop, n_sess_drop = [], [], 0, 0
    for j in range(new_n):
        c, dc = _fill_cooc_shard(cfg, new_n, qstore, pairs,
                                 np.nonzero(owner == j)[0])
        s, ds = _fill_session_shard(base, new_n, sess,
                                    np.nonzero(sess_owner == j)[0], dev)
        coocs.append(c)
        sessions.append(s)
        n_pair_drop += dc
        n_sess_drop += ds

    new_state = ShardedState(
        qstore=qstore, cooc=tuple(coocs), sessions=tuple(sessions),
        tick=state.tick.clone(),
        n_route_drop=torch.zeros((new_n,), dtype=torch.int32, device=dev))
    stats = {"old_n": old_n, "new_n": new_n,
             "n_pairs": int(pairs["src_hi"].size),
             "n_sessions": int(sess["key_hi"].size),
             "n_pair_drop": n_pair_drop, "n_sess_drop": n_sess_drop,
             "old_route_drop": int(state.n_route_drop.sum()),
             "tick": int(state.tick)}
    return new_state, stats


def split_shards(cfg: ShardedConfig, state: ShardedState
                 ) -> Tuple[ShardedState, Dict]:
    """Double the shard count (scale out under lag or memory pressure)."""
    return reshard_sharded_state(cfg, state, 2 * state.n_shards)


def merge_shards(cfg: ShardedConfig, state: ShardedState
                 ) -> Tuple[ShardedState, Dict]:
    """Halve the shard count (scale in when shards run underfilled)."""
    n = state.n_shards
    if n % 2:
        raise ValueError("cannot merge an odd shard count")
    return reshard_sharded_state(cfg, state, n // 2)

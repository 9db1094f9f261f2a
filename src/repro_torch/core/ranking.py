"""Association scoring + ranking cycles (paper §2.4, §4.3 "Ranking cycles").

Port of the JAX package's ``core/ranking.py``: the segmented top-k cycle
:func:`ranking_cycle` over the hash layout, :func:`ranking_cycle_region`
over the region layout, and :func:`ranking_cycle_lexsort`, the
pre-segmented reference pipeline the other two are held against in the
tests (the engine does not call it). Stages of the segmented cycle:

  1. score and gate every cooc slot against the query-store marginals —
     the ``score_gate`` kernel on CUDA (``kernels/ops``);
  2. prefix-sum compaction of gate-passing row ids into an arena, one
     stable u32 grouping sort (bucket id | coarse inverted score), and a
     dense ``[R, L]`` bucket grid built by gathers;
  3. per-bucket top-k — the ``bucket_topk`` kernel on CUDA.

Rows beyond a bucket's arena width ``L`` are cut by coarse score and
counted in ``n_overflow``, never silently. Under the lazy decay policy
every read applies the read-time decayed view.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..kernels import assoc_score as _as
from ..kernels import ops as kops
from . import stores
from .decay import lazy_decayed
from .hashing import MASK32, join_fp, to_np_u32, u32
from .stores import HashTable, RegionTable


@dataclasses.dataclass(frozen=True)
class RankConfig:
    top_k: int = 8
    # linear combination coefficients over (condprob, pmi, llr, chi2)
    coef_condprob: float = 1.0
    coef_pmi: float = 0.15
    coef_llr: float = 0.02
    coef_chi2: float = 0.0
    # evidence gates: "accumulating sufficient evidence" (§2.2)
    min_pair_weight: float = 0.25
    min_src_weight: float = 0.5
    min_pair_count: float = 1.0
    # the selection arena holds seg_arena_frac * capacity gate-passing rows;
    # overflow is cut by table position and counted. >= 1.0 disables it.
    seg_arena_frac: float = 0.5
    # per-bucket arena width L: a source's gate-passing rows beyond its L
    # coarse-score-best are cut and counted.
    bucket_rows: int = 64
    # max sources emitted per cycle; 0 derives the cap from the query
    # store's capacity (which cuts nothing).
    max_sources: int = 0

    def source_cap(self, qstore_capacity: int) -> int:
        return (self.max_sources if self.max_sources > 0
                else qstore_capacity)

    @property
    def coefs(self) -> Tuple[float, float, float, float]:
        return (self.coef_condprob, self.coef_pmi, self.coef_llr,
                self.coef_chi2)


def assoc_scores_jnp(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c):
    """Association score lanes (condprob, pmi, llr, chi2); invalid or
    degenerate entries -> 0. (Name kept from the JAX package.)"""
    return _as.assoc_lanes(w_ab, c_ab, w_a, w_b, c_a, c_b, total_w, total_c)


def combine_scores(cfg: RankConfig, condprob, pmi, llr, chi2):
    """The paper's linear-combination ranker (hand-tuned coefficients)."""
    return _as.combine(cfg.coefs, condprob, pmi, llr, chi2)


class SuggestionTable(NamedTuple):
    """Dense top-k suggestion output of one ranking cycle."""
    src_hi: torch.Tensor    # i32 view of u32[M]
    src_lo: torch.Tensor
    dst_hi: torch.Tensor    # i32 view of u32[M, K]
    dst_lo: torch.Tensor
    score: torch.Tensor     # f32[M, K]  (0 => empty slot)
    n_rows: torch.Tensor    # i32[]
    n_overflow: torch.Tensor  # i32[] — gate-passing rows cut by the arenas


def _score_and_gate(cooc: HashTable, qstore: HashTable, cfg: RankConfig,
                    decay_cfg, now):
    """Marginals lookup, association scoring and evidence gating (with the
    read-time decayed view under the lazy policy).

    Returns (score [-inf where gated], ok mask, src qstore slot, key lanes).
    """
    src_hi, src_lo = cooc.lanes["src_hi"], cooc.lanes["src_lo"]
    dst_hi, dst_lo = cooc.lanes["dst_hi"], cooc.lanes["dst_lo"]
    dkw = dict(decay_cfg=decay_cfg, now=now) if decay_cfg is not None else {}
    src_vals, src_found, src_slot = stores.lookup(qstore, src_hi, src_lo, **dkw)
    dst_vals, dst_found, _ = stores.lookup(qstore, dst_hi, dst_lo, **dkw)
    if decay_cfg is not None:
        total_w = lazy_decayed(decay_cfg, qstore.lanes["weight"],
                               qstore.lanes["last_tick"], now).sum()
    else:
        total_w = qstore.lanes["weight"].sum()
    total_c = qstore.lanes["count"].sum()
    base_ok = cooc.live_mask & src_found & dst_found
    score = kops.score_gate(
        cooc.lanes["weight"], cooc.lanes["count"], src_vals["weight"],
        dst_vals["weight"], src_vals["count"], dst_vals["count"], base_ok,
        total_w, total_c, coefs=cfg.coefs,
        min_pair_weight=cfg.min_pair_weight,
        min_src_weight=cfg.min_src_weight,
        min_pair_count=cfg.min_pair_count,
        decay_cfg=decay_cfg, last_tick=cooc.lanes["last_tick"], now=now)
    return score, score > -torch.inf, src_slot, (src_hi, src_lo, dst_hi, dst_lo)


def _sortable_f32(x: torch.Tensor) -> torch.Tensor:
    """Monotonic f32 -> u32 bit transform (IEEE total order), as int64."""
    sb = x.view(torch.int32).to(torch.int64)
    return torch.where(sb >= 0, sb + 0x80000000, (~sb) & MASK32)


def ranking_cycle(cooc: HashTable, qstore: HashTable, cfg: RankConfig, *,
                  decay_cfg=None, now=None) -> SuggestionTable:
    """One full ranking cycle — segmented top-k.

    Output rows are indexed by bucket run, ``min(Q, M, cfg.max_sources)``
    of them; empty rows keep the (0, 0) src key. Pass ``decay_cfg``/``now``
    under the lazy decay policy.
    """
    C = cooc.capacity
    Q = qstore.capacity
    K = cfg.top_k
    L = max(cfg.bucket_rows, K)
    dev = cooc.key_hi.device
    score, ok, src_slot, keys = _score_and_gate(cooc, qstore, cfg,
                                                decay_cfg, now)
    src_hi, src_lo, dst_hi, dst_lo = keys
    neg_inf = torch.tensor(-torch.inf, device=dev)

    # sort-free stream compaction of gate-passing row ids; overflow beyond
    # the arena is cut by table position and counted.
    if cfg.seg_arena_frac >= 1.0:
        M = C
        idx = torch.arange(C, device=dev)
        arena_spill = torch.zeros((), dtype=torch.int32, device=dev)
        s = torch.where(ok, score, neg_inf)
        seg = torch.where(ok, src_slot, Q)
    else:
        M = min(C, max(K, int(C * cfg.seg_arena_frac)))
        pos = torch.cumsum(ok, 0) - 1
        rows = (ok & (pos < M)).nonzero().squeeze(1)
        idx = torch.full((M,), C, dtype=torch.int64, device=dev)
        idx[pos[rows]] = rows
        arena_spill = torch.clamp_min(ok.sum(dtype=torch.int32) - M, 0)
        filled = idx < C
        safe_idx = torch.clamp(idx, 0, C - 1)
        s = torch.where(filled, score[safe_idx], neg_inf)
        seg = torch.where(filled, src_slot[safe_idx], Q)

    # ONE flat u32 grouping key: bucket id (one extra bit for the sentinel
    # Q) above coarse inverted score bits, so each bucket's rows are
    # contiguous and best-first by coarse score.
    bbits = Q.bit_length()
    qbits = 32 - bbits
    key = (seg << qbits) | ((MASK32 ^ _sortable_f32(s)) >> bbits)
    skey, order = torch.sort(key, stable=True)
    sidx = idx[order]
    sseg = skey >> qbits
    valid_row = sseg < Q
    is_new = torch.ones_like(valid_row)
    is_new[1:] = sseg[1:] != sseg[:-1]
    is_new = is_new & valid_row
    run_id = torch.cumsum(is_new, 0) - 1
    ar = torch.arange(M, device=dev)
    # position within the run: distance to the run's first row (rows past
    # the last run are invalid and masked below).
    starts = torch.cat([is_new.nonzero().squeeze(1), ar[:1]])
    pos_in_run = ar - starts[torch.clamp_min(run_id, 0)]

    # dense [R, L] bucket grid by gathers; run starts by binary search.
    R = min(Q, M, max(cfg.source_cap(Q), 1))
    run_start = torch.searchsorted(run_id, torch.arange(R + 1, device=dev))
    cell = run_start[:R, None] + torch.arange(L, device=dev)[None, :]
    in_run = cell < run_start[1:, None]
    cell_orig = sidx[torch.clamp(cell, 0, M - 1)]
    grid = torch.where(in_run & (cell_orig < C),
                       score[torch.clamp(cell_orig, 0, C - 1)], neg_inf)
    del cell, in_run, cell_orig
    vals, args = kops.bucket_topk(grid, K)
    del grid
    good = vals > -torch.inf

    win_sorted = torch.clamp(run_start[:R, None] + args.to(torch.int64),
                             0, M - 1)
    win_orig = torch.clamp(sidx[win_sorted], 0, C - 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out_dst_hi = torch.where(good, dst_hi[win_orig], zero)
    out_dst_lo = torch.where(good, dst_lo[win_orig], zero)
    out_score = torch.where(good, vals, torch.zeros_like(vals))
    has_run = run_start[:R] < M
    head_orig = torch.clamp(sidx[torch.clamp(run_start[:R], 0, M - 1)],
                            0, C - 1)
    out_src_hi = torch.where(has_run, src_hi[head_orig], zero)
    out_src_lo = torch.where(has_run, src_lo[head_orig], zero)

    n_rows = has_run.sum(dtype=torch.int32)
    select_spill = (valid_row & ((pos_in_run >= L) | (run_id >= R))
                    ).sum(dtype=torch.int32)
    return SuggestionTable(out_src_hi, out_src_lo, out_dst_hi, out_dst_lo,
                           out_score, n_rows, arena_spill + select_spill)


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort(keys)``: stable, the last key primary."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def ranking_cycle_lexsort(cooc: HashTable, qstore: HashTable,
                          cfg: RankConfig, *, decay_cfg=None,
                          now=None, compact_frac: float = 0.5
                          ) -> SuggestionTable:
    """Pre-segmented reference ranking cycle: compact the gate-passing rows
    by a stable descending-score argsort, group them by a stable 3-key
    lexsort (src hi, src lo, then descending score) and emit each run's
    first ``top_k``. Kept for parity tests; the engine does not call it.
    Its only kernel is ``_score_and_gate``'s ``score_gate`` on CUDA.

    ``compact_frac`` (the JAX ``RankConfig.compact_frac``) keeps the
    ``compact_frac * capacity`` best rows before the lexsort, cutting the
    globally lowest-scoring pairs on overflow (counted); >= 1.0 keeps all.
    """
    C = cooc.capacity
    K = cfg.top_k
    dev = cooc.key_hi.device
    score, ok, _, keys = _score_and_gate(cooc, qstore, cfg, decay_cfg, now)
    src_hi, src_lo, dst_hi, dst_lo = keys
    if compact_frac >= 1.0:
        M = C
        c_src_hi, c_src_lo, c_dst_hi, c_dst_lo = keys
        c_score, c_ok = score, ok
        n_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        # the M best rows: gate-passing rows (finite score) lead gated ones
        # (-inf), so an overflow cut drops the globally lowest scores.
        M = min(C, max(K, int(C * compact_frac)))
        sel = torch.argsort(-score, stable=True)[:M]
        c_score = score[sel]
        c_ok = c_score > -torch.inf
        ones = torch.full((), -1, dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        # filler rows get the all-ones src key: their own run, never emitted
        c_src_hi = torch.where(c_ok, src_hi[sel], ones)
        c_src_lo = torch.where(c_ok, src_lo[sel], ones)
        c_dst_hi = torch.where(c_ok, dst_hi[sel], zero)
        c_dst_lo = torch.where(c_ok, dst_lo[sel], zero)
        n_overflow = torch.clamp_min(ok.sum(dtype=torch.int32) - M, 0)

    order = _lexsort(-c_score, u32(c_src_lo), u32(c_src_hi))
    s_hi, s_lo = c_src_hi[order], c_src_lo[order]
    s_dhi, s_dlo = c_dst_hi[order], c_dst_lo[order]
    s_score, s_ok = c_score[order], c_ok[order]
    prev_hi = torch.cat([s_hi.new_full((1,), -1), s_hi[:-1]])
    prev_lo = torch.cat([s_lo.new_full((1,), -1), s_lo[:-1]])
    is_new = (s_hi != prev_hi) | (s_lo != prev_lo)
    seg_id = torch.cumsum(is_new, 0) - 1
    starts = is_new.nonzero().squeeze(1)
    first_idx = torch.zeros((M,), dtype=torch.int64, device=dev)
    first_idx[seg_id[starts]] = starts
    pos = torch.arange(M, device=dev) - first_idx[torch.clamp_min(seg_id, 0)]

    head = (is_new & s_ok).nonzero().squeeze(1)
    out_src_hi = torch.zeros((M,), dtype=torch.int32, device=dev)
    out_src_lo = torch.zeros((M,), dtype=torch.int32, device=dev)
    out_src_hi[seg_id[head]] = s_hi[head]
    out_src_lo[seg_id[head]] = s_lo[head]
    kept = (s_ok & (pos < K)).nonzero().squeeze(1)
    r, p = seg_id[kept], pos[kept]
    out_dst_hi = torch.zeros((M, K), dtype=torch.int32, device=dev)
    out_dst_lo = torch.zeros((M, K), dtype=torch.int32, device=dev)
    out_score = torch.zeros((M, K), dtype=torch.float32, device=dev)
    out_dst_hi[r, p] = s_dhi[kept]
    out_dst_lo[r, p] = s_dlo[kept]
    out_score[r, p] = s_score[kept]
    return SuggestionTable(out_src_hi, out_src_lo, out_dst_hi, out_dst_lo,
                           out_score, (is_new & s_ok).sum(dtype=torch.int32),
                           n_overflow)


def ranking_cycle_region(cooc: RegionTable, qstore: HashTable,
                         cfg: RankConfig, *, decay_cfg=None,
                         now=None) -> SuggestionTable:
    """One full ranking cycle over the source-major region layout.

    The bucket grid is the store itself viewed as ``[n_regions, width]``:
    no sort, no compaction. Source marginals are read by direct index
    (region id = qstore slot), destination marginals by one qstore lookup
    over the key lanes. The ``region_rank`` kernel scores, gates and takes
    each region's top ``min(K, W)``; ``bucket_topk`` then merges each
    source's ``max_chain * K1`` chain candidates into its top K. Ties:
    within a region the lower slot (insertion order) wins, across a chain
    the earlier region. ``n_overflow`` counts gate-passing pairs of sources
    beyond ``cfg.max_sources`` (none at the default cap).
    """
    R, W, MC = cooc.n_regions, cooc.width, cooc.max_chain
    Q = cooc.dir_slots
    K = cfg.top_k
    if Q != qstore.capacity:
        raise ValueError("the directory must be indexed by qstore slot")
    dev = cooc.key_hi.device

    # dst marginals: the key lanes are the destination fingerprints.
    dkw = dict(decay_cfg=decay_cfg, now=now) if decay_cfg is not None else {}
    dst_vals, dst_found, _ = stores.lookup(qstore, cooc.key_hi, cooc.key_lo,
                                           **dkw)
    if decay_cfg is not None:
        total_w = lazy_decayed(decay_cfg, qstore.lanes["weight"],
                               qstore.lanes["last_tick"], now).sum()
    else:
        total_w = qstore.lanes["weight"].sum()
    total_c = qstore.lanes["count"].sum()

    # src marginals: one direct index per region.
    row_valid, ent_ok, referenced = stores.region_chain_state(cooc, qstore)
    ent = cooc.chain_region
    o = torch.clamp(cooc.region_owner, 0, Q - 1).long()
    w_a = qstore.lanes["weight"][o]
    c_a = qstore.lanes["count"][o]
    if decay_cfg is not None:
        w_a = lazy_decayed(decay_cfg, w_a, qstore.lanes["last_tick"][o], now)

    # [R, W] grid scoring and per-region selection. A region holds at most
    # W pairs, so it yields min(K, W) winners; the merge restores K.
    shape = (R, W)
    base_ok = ((cooc.live_mask & dst_found).view(shape)
               & referenced[:, None])
    K1 = min(K, W)
    vals, args, npass_r = kops.region_rank(
        cooc.lanes["weight"].view(shape), cooc.lanes["count"].view(shape),
        w_a, dst_vals["weight"].view(shape), c_a,
        dst_vals["count"].view(shape), base_ok, total_w, total_c, k=K1,
        coefs=cfg.coefs, min_pair_weight=cfg.min_pair_weight,
        min_src_weight=cfg.min_src_weight,
        min_pair_count=cfg.min_pair_count, decay_cfg=decay_cfg,
        last_tick=cooc.lanes["last_tick"].view(shape), now=now)

    # per-source chain merge: top-K over max_chain * K1 candidates.
    S = min(Q, R, max(cfg.source_cap(Q), 1))
    posq = torch.cumsum(row_valid, 0) - 1
    slot_of_row = torch.full((S,), Q, dtype=torch.int64, device=dev)
    act = (row_valid & (posq < S)).nonzero().squeeze(1)
    slot_of_row[posq[act]] = act
    has_slot = slot_of_row < Q
    slot_safe = torch.where(has_slot, slot_of_row, 0)
    ch = torch.where(has_slot[:, None], ent[slot_safe], -1).long()
    cand = torch.where((ch >= 0)[:, :, None], vals[torch.clamp(ch, 0, R - 1)],
                       -torch.inf).reshape(S, MC * K1)
    if MC * K1 < K:   # K exceeds the whole chain's candidate pool
        cand = torch.cat([cand, cand.new_full((S, K - MC * K1), -torch.inf)],
                         1)
    fvals, fidx = kops.bucket_topk(cand.contiguous(), K)
    fidx = fidx.long()
    depth = torch.clamp_max(torch.div(fidx, K1, rounding_mode="floor"),
                            MC - 1)
    reg_w = torch.clamp(torch.gather(ch, 1, depth), 0, R - 1)
    col = args[reg_w, torch.remainder(fidx, K1)].long()
    gslot = reg_w * W + torch.clamp(col, 0, W - 1)
    good = fvals > -torch.inf
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    out_dst_hi = torch.where(good, cooc.key_hi[gslot], zero)
    out_dst_lo = torch.where(good, cooc.key_lo[gslot], zero)
    out_score = torch.where(good, fvals, torch.zeros_like(fvals))
    has_out = good.any(1)
    out_src_hi = torch.where(has_out, cooc.chain_hi[slot_safe], zero)
    out_src_lo = torch.where(has_out, cooc.chain_lo[slot_safe], zero)

    npass_row = torch.where(ent_ok, npass_r[torch.clamp(ent, 0, R - 1).long()],
                            0).sum(1)
    n_overflow = torch.where(row_valid & (posq >= S), npass_row,
                             0).sum(dtype=torch.int32)
    return SuggestionTable(out_src_hi, out_src_lo, out_dst_hi, out_dst_lo,
                           out_score, has_out.sum(dtype=torch.int32),
                           n_overflow)


def suggestions_to_host(table: SuggestionTable) -> dict:
    """Export a SuggestionTable to a host dict keyed by src fp64, skipping
    empty rows (src key (0, 0)) and the all-ones filler key."""
    # select the emitted rows on the device: only they cross to the host.
    mask = ((table.src_hi != 0) | (table.src_lo != 0)) \
        & ~((table.src_hi == -1) & (table.src_lo == -1))
    rows = mask.nonzero().squeeze(1)
    src_fp = join_fp(to_np_u32(table.src_hi[rows]),
                     to_np_u32(table.src_lo[rows]))
    dst_fp = join_fp(to_np_u32(table.dst_hi[rows]),
                     to_np_u32(table.dst_lo[rows]))
    score = table.score[rows].cpu().numpy()
    out = {}
    for fp, drow, srow in zip(src_fp.tolist(), dst_fp.tolist(),
                              score.tolist()):
        row = [(d, s) for d, s in zip(drow, srow) if s > 0.0]
        if row:
            out[fp] = row
    return out

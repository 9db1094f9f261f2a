"""In-memory statistics stores as fixed-capacity, dense-tensor tables.

Port of the JAX package's ``core/stores.py``: the query statistics store
and the hash-layout cooccurrence store (open addressing over (hi, lo) u32
fingerprint pairs), the sessions store (per-session sliding-window rings)
and the source-major region layout of the cooccurrence store
(:class:`RegionTable`). Slot placement is the JAX package's, exactly:

  * a batch is deduplicated with a stable sort on the unsigned (hi, lo)
    key, so each unique key's representative sits at the same batch
    position as in JAX;
  * finds and claims share one sweep (:func:`_find_or_claim`): triangular
    probing, an empty-slot bitmask, and claim rounds in which the lowest
    batch index wins each contended slot (:func:`_claim_winners`);
  * keys that fail to place after ``probe_rounds`` are dropped and counted.

u32 lanes are ``torch.int32`` bit views (see ``hashing.py``); slots are
int64. Updates happen **in place**: a store passed to an insert is consumed
and the returned store shares its storage (the JAX functions return new
arrays; no caller here keeps the old store). The probe loops end as soon as
every row is served, like the JAX ``while_loop``s; rounds past that point
would change nothing. Float segment sums use ``index_add_`` under
deterministic algorithms, so two runs on the card give bit-identical
stores.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .hashing import combine_fp_device, probe_hash, to_np_u32, u32

# Lane reduction modes.
ADD = "add"    # accumulate (weights, counts)
SET = "set"    # last-writer-wins (timestamps, src/dst fps)

# Lane spec for u32 values (stored as int32 bit views) and the engine's
# lanes that use it; export views them back as uint32.
U32 = "u32"
U32_LANES = frozenset({"src_hi", "src_lo", "dst_hi", "dst_lo"})


class HashTable(NamedTuple):
    """Open-addressing hash table over (hi, lo) u32 fingerprint pairs."""
    key_hi: torch.Tensor            # i32 view of u32[C]; (0,0) == empty slot
    key_lo: torch.Tensor
    lanes: Dict[str, torch.Tensor]  # each [C]
    n_dropped: torch.Tensor         # i32[] — updates dropped on probe failure

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]

    @property
    def live_mask(self) -> torch.Tensor:
        return (self.key_hi != 0) | (self.key_lo != 0)

    def live_count(self) -> torch.Tensor:
        return self.live_mask.sum(dtype=torch.int32)


def resolve_device(device="cuda") -> torch.device:
    """The device a store or engine is made on: CUDA unless the caller names
    another. Raises where CUDA is asked for and absent, so nothing falls
    back to the CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def _lane_dtype(spec) -> torch.dtype:
    return torch.int32 if spec == U32 else spec


def make_table(capacity: int, lane_specs: Dict[str, Any],
               device="cuda") -> HashTable:
    """lane_specs: name -> torch dtype, or ``U32``."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    device = resolve_device(device)
    lanes = {name: torch.zeros((capacity,), dtype=_lane_dtype(spec),
                               device=device)
             for name, spec in lane_specs.items()}
    z = lambda: torch.zeros((capacity,), dtype=torch.int32, device=device)
    return HashTable(z(), z(), lanes,
                     torch.zeros((), dtype=torch.int32, device=device))


@contextlib.contextmanager
def deterministic():
    """Scope ``torch.use_deterministic_algorithms(True)`` (restored after)."""
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def _segment_sum(vals: torch.Tensor, seg_id: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """Deterministic segment sum (``jax.ops.segment_sum``)."""
    out = torch.zeros((n,), dtype=vals.dtype, device=vals.device)
    with deterministic():
        out.index_add_(0, seg_id, vals)
    return out


def _probe_slot_dyn(h0: torch.Tensor, r, capacity: int) -> torch.Tensor:
    """Triangular probing: h0 + r(r+1)/2 mod C covers all slots for C=2^k."""
    return (h0 + ((r * (r + 1)) >> 1)) & (capacity - 1)


def _sort_u32_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting rows by the unsigned (hi, lo) pair — the
    same permutation as ``jnp.lexsort((lo, hi))``. The int64 key
    ``(hi - 2**31) * 2**32 + lo`` keeps the unsigned order and fits."""
    key = (u32(hi) - (1 << 31)) * (1 << 32) + u32(lo)
    return torch.sort(key, stable=True).indices


def _run_starts(s_hi: torch.Tensor, s_lo: torch.Tensor) -> torch.Tensor:
    """bool[B]: row starts a run of equal (hi, lo) keys in sorted order."""
    is_new = torch.ones_like(s_hi, dtype=torch.bool)
    is_new[1:] = (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    return is_new


def _claim_winners(slot: torch.Tensor, contend: torch.Tensor, B: int, C: int
                   ) -> torch.Tensor:
    """First-of-each-slot-run claim resolution, deterministic-by-arrival.

    Sorts one packed (slot, batch idx) int64 key, so the winner of every
    contended slot is its lowest batch index by key value. (The JAX
    version's 31-bit packing and its lexsort fallback pick the same
    winners; with int64 the packed form always fits.) Returns bool[B].
    """
    idx = torch.arange(B, device=slot.device)
    bits_b = max((B - 1).bit_length(), 1)
    sent = 1 << 62
    packed = torch.where(contend, (slot << bits_b) | idx,
                         torch.full_like(slot, sent))
    po, order = torch.sort(packed)
    pslot = po >> bits_b
    first = torch.ones_like(contend)
    first[1:] = pslot[1:] != pslot[:-1]
    won = torch.zeros_like(contend)
    won[order] = first & (po != sent)
    return won


def _find_or_claim(key_hi_tab: torch.Tensor, key_lo_tab: torch.Tensor,
                   s_hi: torch.Tensor, s_lo: torch.Tensor,
                   alive: torch.Tensor, probe_rounds: int):
    """Single-sweep find-or-claim over unique keys (the store hot path).

    Sweep 1 records, per row, the slot already holding its key and a
    bitmask of empty slots along its probe sequence; sweep 2 claims: each
    round every unplaced row proposes its next empty-at-snapshot slot, the
    lowest batch index wins each slot, losers fall to their next bit. The
    key tables are written in place. Returns (key_hi_tab, key_lo_tab, slot
    i64[B] (-1 unplaced), placed bool[B], n_dropped i32[]).
    """
    if probe_rounds > 32:
        raise ValueError("empty-slot bitmask holds 32 rounds")
    C = key_hi_tab.shape[0]
    B = s_hi.shape[0]
    h0 = probe_hash(s_hi, s_lo)
    found = torch.full((B,), -1, dtype=torch.int64, device=s_hi.device)
    emp = torch.zeros((B,), dtype=torch.int64, device=s_hi.device)

    for r in range(probe_rounds):
        pending = alive & (found < 0)
        if not bool(pending.any()):
            break
        slot = _probe_slot_dyn(h0, r, C)
        t_hi, t_lo = key_hi_tab[slot], key_lo_tab[slot]
        hit = pending & (t_hi == s_hi) & (t_lo == s_lo)
        found = torch.where(hit, slot, found)
        empty = (t_hi == 0) & (t_lo == 0)
        emp = emp | (empty.to(torch.int64) << r)

    placed = found >= 0
    write_slot = found
    # Claim rounds: every round consumes one candidate bit of each wanting
    # row, so there are at most probe_rounds of them.
    for _ in range(probe_rounds):
        want = alive & ~placed & (emp != 0)
        if not bool(want.any()):
            break
        low = emp & (-emp)                                  # lowest bit
        r = torch.frexp(low.to(torch.float64)).exponent.to(torch.int64) - 1
        slot = _probe_slot_dyn(h0, torch.where(want, r, 0), C)
        still_empty = (key_hi_tab[slot] == 0) & (key_lo_tab[slot] == 0)
        won = _claim_winners(slot, want & still_empty, B, C)
        ws = slot[won]
        key_hi_tab[ws] = s_hi[won]
        key_lo_tab[ws] = s_lo[won]
        write_slot = torch.where(won, slot, write_slot)
        placed = placed | won
        emp = torch.where(want, emp & ~low, emp)

    dropped = (alive & ~placed).sum(dtype=torch.int32)
    return key_hi_tab, key_lo_tab, write_slot, placed, dropped


def _dedup_sorted(key_hi, key_lo, valid):
    """Stable sort by (hi, lo); returns (perm, seg_id, rep_mask).

    rep_mask marks the LAST row of each equal-key run in sorted order, so
    SET lanes take the batch-order latest value. Invalid rows carry key
    (0, 0) and are never representatives.
    """
    perm = _sort_u32_pair(key_hi, key_lo)
    s_hi, s_lo = key_hi[perm], key_lo[perm]
    is_new = _run_starts(s_hi, s_lo)
    seg_id = torch.cumsum(is_new, 0) - 1
    nxt_new = torch.ones_like(is_new)
    nxt_new[:-1] = is_new[1:]
    rep_mask = nxt_new & ((s_hi != 0) | (s_lo != 0)) & valid[perm]
    return perm, seg_id, rep_mask


def _dedup_and_aggregate(key_hi, key_lo, updates, valid, mode_map):
    """Shared insert prologue: mask invalid rows to the empty key, dedup,
    land per-segment lane reductions on every row of the run. Returns
    (s_hi, s_lo, agg, alive) in dedup-sorted batch order; alive marks each
    unique key's representative row."""
    zero = torch.zeros_like(key_hi)
    key_hi = torch.where(valid, key_hi, zero)
    key_lo = torch.where(valid, key_lo, zero)
    B = key_hi.shape[0]
    perm, seg_id, rep_mask = _dedup_sorted(key_hi, key_lo, valid)
    s_hi, s_lo = key_hi[perm], key_lo[perm]
    # Only non-empty keys can be representatives, so the (0, 0) run of
    # masked rows is left out of the sums: summed, that one long run would
    # serialise the deterministic index_add_ on CUDA.
    keyed = ((s_hi != 0) | (s_lo != 0)).nonzero().squeeze(1)
    agg: Dict[str, torch.Tensor] = {}
    for name, upd in updates.items():
        upd_s = upd[perm]
        mode = mode_map[name]
        if mode == ADD:
            agg[name] = _segment_sum(upd_s[keyed], seg_id[keyed], B)[seg_id]
        else:  # SET — the representative row is the last of its run.
            agg[name] = upd_s
    return s_hi, s_lo, agg, rep_mask


def _apply_lane_updates(lanes, agg, mode_map, ok, write_slot, rebase=None):
    """Shared insert epilogue: apply aggregated updates at ``write_slot`` for
    the ``ok`` rows (unique keys => unique slots), in place.

    ``rebase`` (lazy decay policy): name -> decayed current value [B] for ADD
    lanes rebased on write — the slot's value becomes
    ``decayed_current + update``, so read-time decay from the refreshed
    ``last_tick`` stays exact.
    """
    rows = ok.nonzero().squeeze(1)
    ws = write_slot[rows]
    for name, upd in agg.items():
        lane = lanes[name]
        u = upd[rows]
        mode = mode_map[name]
        if rebase is not None and name in rebase:
            lane[ws] = rebase[name][rows] + u
        elif mode == ADD:
            lane[ws] = lane[ws] + u
        else:  # SET
            lane[ws] = u
    return lanes


def insert_accumulate(table: HashTable, key_hi, key_lo,
                      updates: Dict[str, torch.Tensor], valid, *,
                      modes: Tuple[Tuple[str, str], ...],
                      probe_rounds: int = 16, decay_cfg=None,
                      decay_lanes: Tuple[str, ...] = ("weight",),
                      tick_lane: str = "last_tick", now=None) -> HashTable:
    """Batched insert-or-accumulate of (key -> lane updates), in place.

    modes: tuple of (lane_name, ADD|SET). Under the lazy decay policy
    (``decay_cfg`` + ``now``) the ``decay_lanes`` are rebased on write: the
    stored value is decayed from the slot's ``tick_lane`` to ``now`` before
    the update is added.
    """
    mode_map = dict(modes)
    s_hi, s_lo, agg, alive = _dedup_and_aggregate(
        key_hi, key_lo, updates, valid, mode_map)
    key_hi_tab, key_lo_tab, write_slot, placed, dropped = _find_or_claim(
        table.key_hi, table.key_lo, s_hi, s_lo, alive, probe_rounds)
    ok = placed & alive
    rebase = None
    if decay_cfg is not None:
        safe = torch.where(ok, write_slot, 0)
        f = decay_cfg.factor(torch.clamp_min(
            now - table.lanes[tick_lane][safe], 0))
        rebase = {name: table.lanes[name][safe] * f for name in decay_lanes
                  if mode_map.get(name) == ADD}
    lanes = _apply_lane_updates(table.lanes, agg, mode_map, ok, write_slot,
                                rebase=rebase)
    return HashTable(key_hi_tab, key_lo_tab, lanes, table.n_dropped + dropped)


def lookup(table: HashTable, key_hi, key_lo, *, probe_rounds: int = 16,
           decay_cfg=None, decay_lanes: Tuple[str, ...] = ("weight",),
           tick_lane: str = "last_tick", now=None):
    """Batched lookup. Returns (lanes_at_key, found_mask, slot i64 (-1)).

    Under the lazy policy (``decay_cfg`` + ``now``) the returned
    ``decay_lanes`` are the read-time decayed view; the store is untouched.
    """
    C = table.capacity
    h0 = probe_hash(key_hi, key_lo)
    B = key_hi.shape[0]
    nonzero = (key_hi != 0) | (key_lo != 0)
    found_slot = torch.full((B,), -1, dtype=torch.int64, device=key_hi.device)
    for r in range(probe_rounds):
        pending = nonzero & (found_slot < 0)
        if not bool(pending.any()):
            break
        slot = _probe_slot_dyn(h0, r, C)
        hit = pending & (table.key_hi[slot] == key_hi) \
            & (table.key_lo[slot] == key_lo)
        found_slot = torch.where(hit, slot, found_slot)
    found = found_slot >= 0
    safe = torch.where(found, found_slot, 0)
    f = None
    if decay_cfg is not None:
        f = decay_cfg.factor(torch.clamp_min(
            now - table.lanes[tick_lane][safe], 0))
    out = {}
    for name, lane in table.lanes.items():
        v = lane[safe]
        if f is not None and name in decay_lanes:
            v = v * f
        out[name] = torch.where(found, v, torch.zeros_like(v))
    return out, found, found_slot


def export_live(table: HashTable) -> Dict[str, np.ndarray]:
    """Host-side export of live entries; u32 lanes come back as uint32."""
    mask = table.live_mask.cpu().numpy()
    out = {"key_hi": to_np_u32(table.key_hi)[mask],
           "key_lo": to_np_u32(table.key_lo)[mask]}
    for name, lane in table.lanes.items():
        arr = to_np_u32(lane) if name in U32_LANES else lane.cpu().numpy()
        out[name] = arr[mask]
    return out


# ---------------------------------------------------------------------------
# Sessions store: per-session sliding window ring buffers (paper §4.2).
# ---------------------------------------------------------------------------

class SessionTable(NamedTuple):
    key_hi: torch.Tensor    # i32 view of u32[S]
    key_lo: torch.Tensor
    ring_hi: torch.Tensor   # i32 view of u32[S, W] — recent query fps
    ring_lo: torch.Tensor
    ring_src: torch.Tensor  # i32[S, W] — interaction source code per entry
    cursor: torch.Tensor    # i32[S] — next write position
    filled: torch.Tensor    # i32[S] — number of valid ring entries (<= W)
    last_tick: torch.Tensor  # i32[S]
    n_dropped: torch.Tensor  # i32[]

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]

    @property
    def window(self) -> int:
        return self.ring_hi.shape[1]


def make_session_table(capacity: int, window: int, device="cuda"
                       ) -> SessionTable:
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    device = resolve_device(device)
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    return SessionTable(z(capacity), z(capacity), z(capacity, window),
                        z(capacity, window), z(capacity, window), z(capacity),
                        z(capacity), z(capacity), z())


class PairBatch(NamedTuple):
    """Emitted (predecessor -> new query) cooccurrence pairs, [B*W] flat."""
    src_hi: torch.Tensor
    src_lo: torch.Tensor
    src_code: torch.Tensor
    dst_hi: torch.Tensor
    dst_lo: torch.Tensor
    dst_code: torch.Tensor
    valid: torch.Tensor


def update_sessions(table: SessionTable, sess_hi, sess_lo, q_hi, q_lo,
                    src_code, tick, valid, *, probe_rounds: int = 16
                    ) -> Tuple[SessionTable, PairBatch]:
    """Append a micro-batch of queries to their sessions (in place); emit
    pairs.

    Events are processed in batch order per session (a stable sort groups a
    session's events and keeps arrival order); a new query pairs with the W
    most recent predecessors, drawing first from earlier same-batch events,
    then from the pre-batch ring window.
    """
    S, W = table.capacity, table.window
    B = q_hi.shape[0]
    dev = q_hi.device
    zero = torch.zeros_like(sess_hi)
    sess_hi = torch.where(valid, sess_hi, zero)
    sess_lo = torch.where(valid, sess_lo, zero)

    perm = _sort_u32_pair(sess_hi, sess_lo)
    e_shi, e_slo = sess_hi[perm], sess_lo[perm]
    e_qhi, e_qlo = q_hi[perm], q_lo[perm]
    e_src = src_code[perm]
    e_valid = valid[perm] & ((e_shi != 0) | (e_slo != 0))

    is_new_run = _run_starts(e_shi, e_slo)
    seg_id = torch.cumsum(is_new_run, 0) - 1
    ar = torch.arange(B, device=dev)
    run_first = torch.cummax(torch.where(is_new_run, ar, 0), 0).values
    pos_in_run = ar - run_first
    run_len = torch.bincount(seg_id, minlength=B)[seg_id]

    # find/create the session row over the run representatives.
    rep = is_new_run & e_valid
    key_hi_tab, key_lo_tab, row, placed, dropped = _find_or_claim(
        table.key_hi, table.key_lo, e_shi, e_slo, rep, probe_rounds)
    # broadcast the representative's row to every event of its run.
    row = torch.where(rep, row, -1)[run_first]
    e_ok = e_valid & (row >= 0)
    safe_row = torch.where(e_ok, row, 0)

    pre_cursor = table.cursor[safe_row].to(torch.int64)
    pre_filled = table.filled[safe_row].to(torch.int64)

    # emit pairs: d-th most recent predecessor, d = 1..W.
    n_intra = torch.clamp_max(pos_in_run, W)
    pair_src_hi = torch.zeros((B, W), dtype=torch.int32, device=dev)
    pair_src_lo = torch.zeros_like(pair_src_hi)
    pair_src_code = torch.zeros_like(pair_src_hi)
    pair_ok = torch.zeros((B, W), dtype=torch.bool, device=dev)
    for d in range(1, W + 1):
        take_intra = d <= n_intra
        j = torch.clamp_min(ar - d, 0)
        age = d - 1 - n_intra   # >= 0 when not intra
        ring_ok = (~take_intra) & (age < torch.minimum(W - n_intra, pre_filled))
        ring_pos = torch.where(ring_ok,
                               torch.remainder(pre_cursor - 1 - age, W), 0)
        s_hi = torch.where(take_intra, e_qhi[j], table.ring_hi[safe_row, ring_pos])
        s_lo = torch.where(take_intra, e_qlo[j], table.ring_lo[safe_row, ring_pos])
        s_sc = torch.where(take_intra, e_src[j], table.ring_src[safe_row, ring_pos])
        ok = e_ok & (take_intra | ring_ok) & ((s_hi != 0) | (s_lo != 0))
        ok = ok & ~((s_hi == e_qhi) & (s_lo == e_qlo))   # no self-pairs
        pair_src_hi[:, d - 1] = s_hi
        pair_src_lo[:, d - 1] = s_lo
        pair_src_code[:, d - 1] = s_sc
        pair_ok[:, d - 1] = ok

    # write the last min(W, run_len) events of each run into the ring.
    should_write = e_ok & (pos_in_run >= run_len - W)
    wpos = torch.remainder(pre_cursor + pos_in_run, W)
    rows = should_write.nonzero().squeeze(1)
    wr, wp = safe_row[rows], wpos[rows]
    table.ring_hi[wr, wp] = e_qhi[rows]
    table.ring_lo[wr, wp] = e_qlo[rows]
    table.ring_src[wr, wp] = e_src[rows]

    # cursor/filled advance once per run (applied at the run's last event).
    is_last = torch.ones_like(is_new_run)
    is_last[:-1] = is_new_run[1:]
    adv = (e_ok & is_last).nonzero().squeeze(1)
    a_row = safe_row[adv]
    table.cursor[a_row] = torch.remainder(pre_cursor + run_len, W)[adv].to(
        torch.int32)
    table.filled[a_row] = torch.clamp_max(pre_filled + run_len, W)[adv].to(
        torch.int32)
    table.last_tick[a_row] = torch.as_tensor(tick, dtype=torch.int32,
                                             device=dev)

    new_table = table._replace(key_hi=key_hi_tab, key_lo=key_lo_tab,
                               n_dropped=table.n_dropped + dropped)
    pairs = PairBatch(
        src_hi=pair_src_hi.reshape(-1),
        src_lo=pair_src_lo.reshape(-1),
        src_code=pair_src_code.reshape(-1),
        dst_hi=e_qhi[:, None].expand(B, W).reshape(-1),
        dst_lo=e_qlo[:, None].expand(B, W).reshape(-1),
        dst_code=e_src[:, None].expand(B, W).reshape(-1),
        valid=pair_ok.reshape(-1),
    )
    return new_table, pairs


def evict_sessions(table: SessionTable, tick, ttl: int) -> SessionTable:
    """Prune sessions with no recent activity (the decay/prune cycle)."""
    live = (table.key_hi != 0) | (table.key_lo != 0)
    keep = ~(live & ((tick - table.last_tick) > ttl))
    z = torch.zeros_like(table.key_hi)
    return table._replace(
        key_hi=torch.where(keep, table.key_hi, z),
        key_lo=torch.where(keep, table.key_lo, z),
        cursor=torch.where(keep, table.cursor, z),
        filled=torch.where(keep, table.filled, z),
    )


# ---------------------------------------------------------------------------
# Source-major region layout for the cooccurrence store.
#
# Regions of ``width`` slots are pool-allocated to sources and chained
# through a directory indexed by the source's qstore slot. A slot's key is
# the destination fingerprint only: the region implies the source, so the
# hash layout's four endpoint lanes are gone (5 lanes per pair, not 9).
# Invariants: live slots of a region are its packed prefix [0, fill);
# chains are -1-terminated prefixes of regions owned by their slot; a free
# region (owner -1) is empty.
# ---------------------------------------------------------------------------

class RegionTable(NamedTuple):
    """Source-major cooccurrence store (see the section comment)."""
    key_hi: torch.Tensor        # i32 view of u32[C]: dst fp; (0,0) == empty
    key_lo: torch.Tensor
    lanes: Dict[str, torch.Tensor]  # each [C] (1-D only)
    chain_region: torch.Tensor  # i32[Q, MC]: region ids, -1 = none (prefix)
    chain_hi: torch.Tensor      # i32 view of u32[Q]: source fp owning slot q
    chain_lo: torch.Tensor
    region_fill: torch.Tensor   # i32[R]: live pairs, packed at [0, fill)
    region_owner: torch.Tensor  # i32[R]: owning qstore slot, -1 = free
    n_dropped: torch.Tensor     # i32[]: src-missing / chain-full / pool-empty

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]

    @property
    def n_regions(self) -> int:
        return self.region_fill.shape[0]

    @property
    def width(self) -> int:
        return self.capacity // self.n_regions

    @property
    def max_chain(self) -> int:
        return self.chain_region.shape[1]

    @property
    def dir_slots(self) -> int:
        return self.chain_region.shape[0]

    @property
    def live_mask(self) -> torch.Tensor:
        return (self.key_hi != 0) | (self.key_lo != 0)

    def live_count(self) -> torch.Tensor:
        return self.live_mask.sum(dtype=torch.int32)

    def free_regions(self) -> torch.Tensor:
        """Freelist pressure: regions available for allocation."""
        return (self.region_owner < 0).sum(dtype=torch.int32)


def make_region_table(capacity: int, region_width: int, dir_slots: int,
                      max_chain: int, lane_specs: Dict[str, Any],
                      device="cuda") -> RegionTable:
    """``dir_slots`` must equal the qstore capacity (region id = qstore
    slot); ``capacity = n_regions * region_width``. On CUDA unless
    ``device`` names another device; raises where CUDA is absent."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    if region_width <= 0 or region_width & (region_width - 1) \
            or capacity < region_width:
        raise ValueError("region_width must be a power of two <= capacity")
    if max_chain < 1:
        raise ValueError("max_chain must be at least 1")
    device = resolve_device(device)
    n_regions = capacity // region_width
    i32 = dict(dtype=torch.int32, device=device)
    lanes = {name: torch.zeros((capacity,), dtype=_lane_dtype(spec),
                               device=device)
             for name, spec in lane_specs.items()}
    return RegionTable(
        key_hi=torch.zeros((capacity,), **i32),
        key_lo=torch.zeros((capacity,), **i32),
        lanes=lanes,
        chain_region=torch.full((dir_slots, max_chain), -1, **i32),
        chain_hi=torch.zeros((dir_slots,), **i32),
        chain_lo=torch.zeros((dir_slots,), **i32),
        region_fill=torch.zeros((n_regions,), **i32),
        region_owner=torch.full((n_regions,), -1, **i32),
        n_dropped=torch.zeros((), **i32))


def region_chain_state(table: RegionTable, qstore: HashTable
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain-validity rule shared by ranking and the sweeps: a
    directory row is live iff it has a chain head and its recorded
    fingerprint still owns that qstore slot. Returns

      * ``row_valid`` bool[Q]: directory rows with a live, owned chain,
      * ``ent_ok`` bool[Q, MC]: live chain entries,
      * ``referenced`` bool[R]: regions reachable from a live chain.
    """
    if table.dir_slots != qstore.capacity:
        raise ValueError("the directory must be indexed by qstore slot")
    row_valid = ((table.chain_region[:, 0] >= 0)
                 & (qstore.key_hi == table.chain_hi)
                 & (qstore.key_lo == table.chain_lo)
                 & qstore.live_mask)
    ent_ok = (table.chain_region >= 0) & row_valid[:, None]
    referenced = torch.zeros((table.n_regions,), dtype=torch.bool,
                             device=row_valid.device)
    referenced[table.chain_region[ent_ok].long()] = True
    return row_valid, ent_ok, referenced


def _group_ranks(slot: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rank (0-based) of each masked row within its slot group, in row
    order; unmasked rows get garbage ranks (callers mask).

    One int64 key ``(slot << 32) | idx`` sorts masked rows by slot, then
    by row index. The JAX version packs a u32 key when it fits 31 bits and
    lexsorts (idx, slot) otherwise; both orders are this one, so the ranks
    are the same in both of its cases.
    """
    B = slot.shape[0]
    idx = torch.arange(B, device=slot.device)
    packed = torch.where(mask, (slot << 32) | idx,
                         torch.full_like(idx, 1 << 62))
    po, order = torch.sort(packed, stable=True)
    pslot = po >> 32
    is_new = torch.ones_like(mask)
    is_new[1:] = pslot[1:] != pslot[:-1]
    rank_sorted = idx - torch.cummax(torch.where(is_new, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order] = rank_sorted
    return rank


def _region_chains(table: RegionTable, qstore: HashTable, src_hi, src_lo,
                   active, probe_rounds: int):
    """Each pair's source slot and chain: (active & source in the qstore,
    its slot i64 (0 where absent), chain_ok (the slot holds a chain
    stamped with this source), regs i32[B, MC] with -1 where not)."""
    _, src_found, qslot = lookup(qstore, src_hi, src_lo,
                                 probe_rounds=probe_rounds)
    active = active & src_found
    qslot = torch.where(active, qslot, 0)
    chain_ok = (active & (table.chain_region[qslot, 0] >= 0)
                & (table.chain_hi[qslot] == src_hi)
                & (table.chain_lo[qslot] == src_lo))
    regs = torch.where(chain_ok[:, None], table.chain_region[qslot], -1)
    return active, qslot, chain_ok, regs


def _chain_find(table: RegionTable, regs, dst_hi, dst_lo, active
                ) -> torch.Tensor:
    """Global slot of each pair's dst key along its chain, or -1 (i64);
    the ``chain_find`` kernel on CUDA."""
    R, W = table.n_regions, table.width
    return kops.chain_find(table.key_hi.view(R, W), table.key_lo.view(R, W),
                           regs, dst_hi, dst_lo, active).long()


def region_insert_accumulate(table: RegionTable, qstore: HashTable,
                             src_hi, src_lo, dst_hi, dst_lo,
                             updates: Dict[str, torch.Tensor], valid, *,
                             modes: Tuple[Tuple[str, str], ...],
                             probe_rounds: int = 16, decay_cfg=None,
                             decay_lanes: Tuple[str, ...] = ("weight",),
                             tick_lane: str = "last_tick",
                             now=None) -> RegionTable:
    """Batched insert-or-accumulate of (src -> dst) pairs, region layout,
    in place.

    The source's qstore slot names its chain: finds scan the chain's
    region rows, claims append at each region's fill tail in chain order,
    and new regions come off the freelist in ascending-id order.
    Accumulation (dedup by the combined pair fingerprint, ADD/SET lanes,
    lazy rebase-on-write) is :func:`insert_accumulate`'s. Drops (source
    absent from the qstore, chain full, pool empty) count in
    ``n_dropped``.
    """
    R, W, MC = table.n_regions, table.width, table.max_chain
    mode_map = dict(modes)
    dev = src_hi.device

    # dedup by the combined pair fp; src/dst ride along as SET lanes so
    # the representatives carry them.
    p_hi, p_lo = combine_fp_device(src_hi, src_lo, dst_hi, dst_lo)
    ends = {"_src_hi": src_hi, "_src_lo": src_lo,
            "_dst_hi": dst_hi, "_dst_lo": dst_lo}
    _, _, agg, alive = _dedup_and_aggregate(
        p_hi, p_lo, {**updates, **ends}, valid,
        {**mode_map, **{n: SET for n in ends}})
    a_src_hi, a_src_lo = agg.pop("_src_hi"), agg.pop("_src_lo")
    a_dst_hi, a_dst_lo = agg.pop("_dst_hi"), agg.pop("_dst_lo")

    alive2, qslot, chain_ok, regs = _region_chains(
        table, qstore, a_src_hi, a_src_lo, alive, probe_rounds)
    n_src_miss = (alive & ~alive2).sum(dtype=torch.int32)
    found = _chain_find(table, regs, a_dst_hi, a_dst_lo, alive2)

    # claim: rank new pairs within their source and map the ranks onto
    # the chain's free tail space (earlier regions' tails fill first).
    new = alive2 & (found < 0)
    rank = _group_ranks(qslot, new)
    f_d = torch.where(regs >= 0,
                      table.region_fill[torch.clamp(regs, 0, R - 1).long()],
                      0).long()
    avail = W - f_d                       # an unallocated depth has W free
    cumavail = torch.cumsum(avail, 1)
    prev_cum = cumavail - avail
    in_d = new[:, None] & (rank[:, None] >= prev_cum) \
        & (rank[:, None] < cumavail)
    d_star = torch.argmax(in_d.to(torch.uint8), 1)   # first True depth
    has_room = in_d.any(1)

    def take1(a):
        return torch.gather(a, 1, d_star[:, None])[:, 0]

    pos = rank - take1(prev_cum) + take1(f_d)
    reg_at = take1(regs).long()
    n_chain_full = (new & ~has_room).sum(dtype=torch.int32)

    # allocation: one representative per needed (slot, depth), given free
    # regions in ascending region-id order of (slot, depth).
    rep = new & has_room & (reg_at < 0) & (pos == 0)
    big = torch.iinfo(torch.int64).max
    okey = torch.where(rep, qslot * MC + d_star, big)
    order = torch.sort(okey, stable=True).indices
    t = torch.empty_like(okey)
    t[order] = torch.where(okey[order] < big,
                           torch.arange(okey.shape[0], device=dev),
                           okey.shape[0])
    free_ids = (table.region_owner < 0).nonzero().squeeze(1)
    n_free = free_ids.shape[0]
    got = rep & (t < n_free)
    alloc_region = torch.full_like(okey, -1)
    alloc_region[got] = free_ids[t[got]]

    # directory writes: stale or new rows reset wholesale (the previous
    # owner's chain is orphaned; a sweep reclaims it), then the allocated
    # entries land, then the owning fp is stamped.
    cr = table.chain_region
    reset = (new & ~chain_ok).nonzero().squeeze(1)
    cr[qslot[reset]] = -1
    table.chain_hi[qslot[reset]] = a_src_hi[reset]
    table.chain_lo[qslot[reset]] = a_src_lo[reset]
    ok_rep = got.nonzero().squeeze(1)
    cr[qslot[ok_rep], d_star[ok_rep]] = alloc_region[ok_rep].to(torch.int32)
    table.region_owner[alloc_region[ok_rep]] = qslot[ok_rep].to(torch.int32)

    # final placement: re-read the directory, which covers freshly
    # allocated regions and pool-exhaustion failures in one gather.
    reg_final = torch.where(reg_at >= 0, reg_at, cr[qslot, d_star].long())
    placed_new = new & has_room & (reg_final >= 0)
    n_pool_full = (new & has_room & (reg_final < 0)).sum(dtype=torch.int32)
    gslot = reg_final * W + pos
    rows = placed_new.nonzero().squeeze(1)
    table.key_hi[gslot[rows]] = a_dst_hi[rows]
    table.key_lo[gslot[rows]] = a_dst_lo[rows]
    table.region_fill.add_(torch.bincount(reg_final[rows], minlength=R)
                           .to(torch.int32))

    write_slot = torch.where(found >= 0, found,
                             torch.where(placed_new, gslot, -1))
    ok = alive2 & (write_slot >= 0)
    rebase = None
    if decay_cfg is not None:
        safe = torch.where(ok, write_slot, 0)
        f = decay_cfg.factor(torch.clamp_min(
            now - table.lanes[tick_lane][safe], 0))
        rebase = {name: table.lanes[name][safe] * f for name in decay_lanes
                  if mode_map.get(name) == ADD}
    lanes = _apply_lane_updates(table.lanes, agg, mode_map, ok, write_slot,
                                rebase=rebase)
    return table._replace(
        lanes=lanes,
        n_dropped=table.n_dropped + n_src_miss + n_chain_full + n_pool_full)


def region_lookup(table: RegionTable, qstore: HashTable, src_hi, src_lo,
                  dst_hi, dst_lo, *, probe_rounds: int = 16, decay_cfg=None,
                  decay_lanes: Tuple[str, ...] = ("weight",),
                  tick_lane: str = "last_tick", now=None):
    """Batched pair lookup under the region layout, :func:`lookup`'s
    contract (read-time decayed view under the lazy policy). Returns
    (lanes_at_pair, found_mask, global slot i64 (-1))."""
    nonzero = (src_hi != 0) | (src_lo != 0)
    _, _, chain_ok, regs = _region_chains(table, qstore, src_hi, src_lo,
                                          nonzero, probe_rounds)
    found_slot = _chain_find(table, regs, dst_hi, dst_lo, chain_ok)
    found = found_slot >= 0
    safe = torch.where(found, found_slot, 0)
    f = None
    if decay_cfg is not None:
        f = decay_cfg.factor(torch.clamp_min(
            now - table.lanes[tick_lane][safe], 0))
    out = {}
    for name, lane in table.lanes.items():
        v = lane[safe]
        if f is not None and name in decay_lanes:
            v = v * f
        out[name] = torch.where(found, v, torch.zeros_like(v))
    return out, found, found_slot


# ---------------------------------------------------------------------------
# Delta snapshots: dirty-row extraction over host copies of the leaves.
# ---------------------------------------------------------------------------

def diff_leading_rows(prev: np.ndarray, new: np.ndarray) -> np.ndarray:
    """The leading indices (slots) where ``new`` differs from ``prev``: the
    rows a delta snapshot records (the JAX package's function of the same
    name). A content compare, so it is exact under every policy and layout
    (an eager sweep rewrites every live weight and the delta grows to
    match). NaN != NaN only ever adds rows, never loses one."""
    if prev.shape != new.shape or prev.dtype != new.dtype:
        raise ValueError(f"diff_leading_rows: {prev.shape} {prev.dtype} "
                         f"against {new.shape} {new.dtype}")
    neq = prev != new
    if neq.ndim > 1:
        neq = neq.reshape(neq.shape[0], -1).any(axis=1)
    return np.nonzero(neq)[0].astype(np.int64)


def apply_row_delta(base: np.ndarray, idx: np.ndarray,
                    rows: np.ndarray) -> np.ndarray:
    """Scatter a delta's changed rows onto the base snapshot's array, in
    place when it is writable (npz loads are). Inverse of
    :func:`diff_leading_rows` given the base it was diffed against."""
    if not base.flags.writeable:
        base = base.copy()
    base[idx] = rows
    return base

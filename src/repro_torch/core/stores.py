"""In-memory statistics stores as fixed-capacity, dense-tensor hash tables.

Port of the hash half of the JAX package's ``core/stores.py``: the query
statistics store and the hash-layout cooccurrence store (open addressing
over (hi, lo) u32 fingerprint pairs) and the sessions store (per-session
sliding-window rings). Slot placement is the JAX package's, exactly:

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

from .hashing import probe_hash, to_np_u32, u32

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

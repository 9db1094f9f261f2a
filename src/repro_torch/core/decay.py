"""Temporal decay of accumulated statistics (paper §2.4, §4.3).

Port of the JAX package's ``core/decay.py``. Two policies:

  * ``sweep`` — the paper's periodic decay cycle: one pass over the table
    multiplying every weight lane and clearing pruned slots. On CUDA it is
    the hand-written ``decay_prune_multi`` kernel (``kernels/ops``).
  * ``lazy`` — reads apply ``w * factor(now - last_tick)``, writes rebase
    before adding, and only :func:`prune_sweep` runs, at a longer cadence.

Exponential decay is memoryless, so the two compose to the same values.
The region layout's sweeps (:func:`region_decay_sweep`,
:func:`region_prune_sweep`) add the region maintenance; the JAX package
computes them in jnp, outside any Pallas kernel, and so do these in torch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..kernels import ops as kops
from .stores import HashTable, RegionTable, region_chain_state

EXP, LINEAR, STEP = "exp", "linear", "step"


@dataclasses.dataclass(frozen=True)
class DecayConfig:
    kind: str = EXP            # exp | linear | step
    half_life_ticks: float = 36.0   # exp: ticks to halve a weight
    linear_slope: float = 0.01      # linear: weight lost per tick
    step_every: int = 72            # step: every N ticks ...
    step_factor: float = 0.5        # ... multiply by this
    prune_threshold: float = 0.05   # drop entries below this weight
    policy: str = "sweep"           # sweep | lazy

    def factor(self, dticks) -> torch.Tensor:
        """Multiplicative f32 decay factor for an elapsed number of ticks
        (a python number gives a 0-d CPU tensor, a tensor keeps its
        device)."""
        dt = torch.as_tensor(dticks).to(torch.float32)
        if self.kind == EXP:
            return torch.exp2(-dt / self.half_life_ticks)
        if self.kind == LINEAR:
            return torch.clamp_min(1.0 - self.linear_slope * dt, 0.0)
        if self.kind == STEP:
            return self.step_factor ** torch.floor(dt / self.step_every)
        raise ValueError(self.kind)

    def factor_py(self, dticks: float) -> float:
        """The decay factor as a host float (the reference engine's)."""
        if self.kind == EXP:
            return 2.0 ** (-dticks / self.half_life_ticks)
        if self.kind == LINEAR:
            return max(1.0 - self.linear_slope * dticks, 0.0)
        if self.kind == STEP:
            return self.step_factor ** math.floor(dticks / self.step_every)
        raise ValueError(self.kind)


def _apply_decay_prune(table: HashTable, f, cfg: DecayConfig,
                       weight_lanes: Tuple[str, ...],
                       tick_override=None, tick_lane: str = "last_tick"):
    """Shared sweep epilogue: decay the weight lanes by ``f`` (scalar or
    per-row), prune below ``cfg.prune_threshold`` on the primary lane, clear
    every other lane and the keys on pruned slots; optionally re-anchor
    ``tick_lane`` to ``tick_override`` on survivors (the lazy prune sweep).
    Returns (table, live_count, total_weight-after)."""
    lanes = dict(table.lanes)
    primary = weight_lanes[0]
    decayed = {name: lanes[name] * f for name in weight_lanes}
    keep = table.live_mask & (decayed[primary] >= cfg.prune_threshold)
    for name in weight_lanes:
        lanes[name] = torch.where(keep, decayed[name],
                                  torch.zeros_like(decayed[name]))
    if tick_override is not None:
        lt = lanes[tick_lane]
        lanes[tick_lane] = torch.where(
            keep, torch.as_tensor(tick_override, dtype=lt.dtype,
                                  device=lt.device).expand(keep.shape),
            torch.zeros_like(lt))
    for name, lane in lanes.items():
        if name in weight_lanes or (tick_override is not None
                                    and name == tick_lane):
            continue
        lanes[name] = torch.where(keep, lane, torch.zeros_like(lane))
    z = torch.zeros_like(table.key_hi)
    new = table._replace(key_hi=torch.where(keep, table.key_hi, z),
                         key_lo=torch.where(keep, table.key_lo, z),
                         lanes=lanes)
    return new, keep.sum(dtype=torch.int32), lanes[primary].sum()


def sweep_decay_prune(table: HashTable, dticks, *, cfg: DecayConfig,
                      weight_lanes: Tuple[str, ...] = ("weight",)):
    """The paper's decay/prune cycle over the whole table, through the
    ``decay_prune_multi`` kernel on CUDA (its plain version on the CPU).
    Returns (table, live_count, total_weight-after)."""
    return kops.decay_prune_table(table, dticks, cfg=cfg,
                                  weight_lanes=weight_lanes)


def lazy_decayed(cfg: DecayConfig, weight, last_tick, now) -> torch.Tensor:
    """Read-time decayed view of a weight lane under the lazy policy."""
    return weight * cfg.factor(torch.clamp_min(now - last_tick, 0))


def prune_sweep(table: HashTable, now, *, cfg: DecayConfig,
                weight_lanes: Tuple[str, ...] = ("weight",),
                tick_lane: str = "last_tick"):
    """Prune-only sweep for the lazy policy (runs at ``prune_every``).

    Materializes each entry's read-time decayed view, prunes entries whose
    decayed primary weight fell under the threshold, and re-anchors
    ``tick_lane = now`` on survivors. Returns (table, live_count,
    total_weight-after, reclaimed_slots).
    """
    live_before = table.live_mask.sum(dtype=torch.int32)
    f = cfg.factor(torch.clamp_min(now - table.lanes[tick_lane], 0))
    new, live, tot = _apply_decay_prune(table, f, cfg, weight_lanes,
                                        tick_override=now,
                                        tick_lane=tick_lane)
    return new, live, tot, live_before - live


# ---------------------------------------------------------------------------
# Region-layout sweeps (source-major cooccurrence store).
# ---------------------------------------------------------------------------

def _pack_rows(x: torch.Tensor, keep: torch.Tensor, fill_value
               ) -> torch.Tensor:
    """Move each row's kept entries to its front, in order; the rest of the
    row takes ``fill_value``. Equals the JAX sweeps' stable argsort of
    ``~keep`` per row followed by a gather, because every entry that is not
    kept already holds ``fill_value`` there."""
    rows, width = keep.shape
    dest = torch.cumsum(keep, 1) - 1 + torch.arange(
        rows, device=keep.device)[:, None] * width
    out = torch.full((rows * width,), fill_value, dtype=x.dtype,
                     device=x.device)
    flat = keep.reshape(-1)
    out[dest.reshape(-1)[flat]] = x.reshape(-1)[flat]
    return out


def _region_sweep(table: RegionTable, qstore: HashTable, f,
                  cfg: DecayConfig, weight_lanes: Tuple[str, ...],
                  tick_override, tick_lane: str):
    """Shared region sweep: decay + prune per slot, then restore the
    layout's invariants: compact every region live-first (insertion order
    kept), recount ``region_fill``, reclaim orphaned chains (source pruned
    from the qstore, or its slot taken by another fingerprint), unlink
    emptied regions from their chains and return them to the freelist.
    Returns (table, live, total_weight, reclaimed)."""
    R, W = table.n_regions, table.width
    lanes = dict(table.lanes)
    primary = weight_lanes[0]
    live = table.live_mask
    live_before = live.sum(dtype=torch.int32)
    decayed = {name: lanes[name] * f for name in weight_lanes}
    keep = live & (decayed[primary] >= cfg.prune_threshold)

    # a chain whose source no longer owns its qstore slot is dead.
    _, ent_ok, referenced = region_chain_state(table, qstore)
    keep = keep & referenced.repeat_interleave(W)

    # cleared slots zero every lane: a freed slot's last_tick feeds later
    # rebase-on-write.
    for name in weight_lanes:
        lanes[name] = torch.where(keep, decayed[name],
                                  torch.zeros_like(decayed[name]))
    if tick_override is not None:
        lt = lanes[tick_lane]
        lanes[tick_lane] = torch.where(
            keep, torch.as_tensor(tick_override, dtype=lt.dtype,
                                  device=lt.device).expand(keep.shape),
            torch.zeros_like(lt))
    for name, lane in lanes.items():
        if name in weight_lanes or (tick_override is not None
                                    and name == tick_lane):
            continue
        lanes[name] = torch.where(keep, lane, torch.zeros_like(lane))

    # compact each region live-first.
    keep2 = keep.reshape(R, W)
    zero = torch.zeros_like(table.key_hi)
    key_hi = _pack_rows(torch.where(keep, table.key_hi, zero), keep2, 0)
    key_lo = _pack_rows(torch.where(keep, table.key_lo, zero), keep2, 0)
    lanes = {name: _pack_rows(lane, keep2, 0) for name, lane in lanes.items()}
    fill = keep2.sum(1, dtype=torch.int32)
    owner = torch.where(fill > 0, table.region_owner, -1)

    # unlink emptied regions; close the hole so chains stay prefixes.
    ent = table.chain_region
    fill_at_ent = torch.where(ent_ok, fill[torch.clamp(ent, 0, R - 1).long()],
                              0)
    ent_keep = ent_ok & (fill_at_ent > 0)
    chain_region = _pack_rows(ent, ent_keep, -1).reshape(ent.shape)

    new = table._replace(key_hi=key_hi, key_lo=key_lo, lanes=lanes,
                         chain_region=chain_region, region_fill=fill,
                         region_owner=owner)
    live_after = keep.sum(dtype=torch.int32)
    return new, live_after, lanes[primary].sum(), live_before - live_after


def region_prune_sweep(table: RegionTable, qstore: HashTable, now, *,
                       cfg: DecayConfig,
                       weight_lanes: Tuple[str, ...] = ("weight",),
                       tick_lane: str = "last_tick"):
    """:func:`prune_sweep` for the region layout (lazy policy): read-time
    decay materialised per slot, prune, and the region maintenance of
    :func:`_region_sweep`. Returns (table, live, total_weight,
    reclaimed)."""
    f = cfg.factor(torch.clamp_min(now - table.lanes[tick_lane], 0))
    return _region_sweep(table, qstore, f, cfg, weight_lanes, now, tick_lane)


def region_decay_sweep(table: RegionTable, qstore: HashTable, dticks, *,
                       cfg: DecayConfig,
                       weight_lanes: Tuple[str, ...] = ("weight",)):
    """:func:`sweep_decay_prune` for the region layout (sweep policy):
    scalar decay factor, same prune and region maintenance. Returns
    (table, live, total_weight, reclaimed)."""
    return _region_sweep(table, qstore, cfg.factor(dticks), cfg,
                         weight_lanes, None, "last_tick")

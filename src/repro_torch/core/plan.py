"""Store sizing derived from the configuration, and a reader of tuned plans.

Port of ``default_region_width`` from the JAX package's ``core/plan.py``,
and of what ``TunedPlan.from_json(d).variants()`` returns, so that a
frontend reports the plan a JAX-written snapshot carries
(:func:`tuned_variants`). The rest of that module (``TunedPlan`` itself,
the per-op kernel choice and its dispatch) has no counterpart here: on
CUDA every hot path runs its kernel, and the port writes no plan.
"""
from __future__ import annotations

from typing import Dict

# The hot paths a JAX ``TunedPlan`` chooses a variant for, in its field
# order, and the two tuning knobs its ``variants()`` adds, with the
# defaults of its all-jnp plan.
HOT_PATH_OPS = ("score_gate", "bucket_topk", "region_rank", "chain_find",
                "decay_prune")
VARIANTS = ("kernel", "jnp")
_KNOBS = {"score_block_rows": 16, "ingest_chunk": 0}


def default_region_width(cooc_capacity: int) -> int:
    """Default pairs-per-region derived from the cooc capacity.

    {2^16: 16, 2^18: 32, 2^20: 64, >= 2^22: 128}: width grows with the
    square root of capacity (bigger stores hold fatter heads), clamped to
    [8, 128], the widths the region kernels keep in registers.
    """
    if cooc_capacity <= 0:
        raise ValueError(f"bad cooc_capacity {cooc_capacity}")
    log2c = cooc_capacity.bit_length() - 1
    return 1 << min(7, max(3, log2c // 2 - 4))


def tuned_variants(plan: Dict) -> Dict:
    """op -> variant of a JAX ``TunedPlan`` in its json form (a snapshot's
    ``plan`` meta), as ``TunedPlan.from_json(plan).variants()`` gives it:
    missing fields take the all-jnp defaults, unknown ones are ignored, and
    a hot path whose choice is neither ``"kernel"`` nor ``"jnp"`` raises
    ``ValueError``."""
    out = {}
    for op in HOT_PATH_OPS:
        v = plan.get(op, "jnp")
        if v not in VARIANTS:
            raise ValueError(f"plan.{op} must be 'kernel' or 'jnp', "
                             f"got {v!r}")
        out[op] = v
    for knob, default in _KNOBS.items():
        out[knob] = plan.get(knob, default)
    return out

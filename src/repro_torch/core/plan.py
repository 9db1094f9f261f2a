"""TunedPlan: the serializable record of the autotuner, and store sizing.

Port of the JAX package's ``core/plan.py``. A ``TunedPlan`` holds one
variant per hot path (``"kernel"`` or ``"jnp"``), two tuning knobs and its
provenance, and its JSON is the JAX plan's field for field, so a plan that
either package wrote (the autotune cache, a snapshot's ``plan`` meta)
loads in the other.

What the plan means in the port differs from JAX, where ``EngineConfig``
carries it and it routes each hot path between its Pallas kernel and its
jnp twin and fuses ingest slices. Here the device routes: on CUDA every
hot path launches its hand-written kernel, on the CPU it runs its plain
torch twin (``kernels/__init__``), and the engine holds no plan. The plan
is the tuner's record of that route (:func:`device_route`) and of its
timings' shape class: ``serve_assist --autotune`` writes it into the
persisted tables' meta, where the frontends report it. Its two knobs ride
the JSON unread: ``ingest_chunk`` (the engine ingests one quantum slice a
call whatever it says) and ``score_block_rows`` (``score_gate.cu``'s tile
is fixed at 2,048 slots).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import torch

# The hot paths a plan chooses a variant for, in its field order.
HOT_PATH_OPS: Tuple[str, ...] = (
    "score_gate", "bucket_topk", "region_rank", "chain_find", "decay_prune")

KERNEL, JNP = "kernel", "jnp"

# The hot paths each cooc layout runs (those the tuner measures): the
# hash layout ranks with score_gate + bucket_topk, the
# region layout probes with chain_find and ranks with region_rank; both
# sweep with decay_prune. (The region chain merge's top-k is not a plan
# op, in JAX either.)
LAYOUT_OPS: Dict[str, Tuple[str, ...]] = {
    "hash": ("score_gate", "bucket_topk", "decay_prune"),
    "region": ("region_rank", "chain_find", "decay_prune"),
}

# The kernel (its name in ``kernels.LAUNCHES``) each hot path launches on
# CUDA.
OP_KERNELS: Dict[str, str] = {
    "score_gate": "score_gate", "bucket_topk": "bucket_topk",
    "region_rank": "region_rank", "chain_find": "chain_find",
    "decay_prune": "decay_prune_multi"}


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """Per-hot-path variants, tuning knobs and provenance. Defaults are the
    all-jnp plan."""
    score_gate: str = JNP
    bucket_topk: str = JNP
    region_rank: str = JNP
    chain_find: str = JNP
    decay_prune: str = JNP
    # rows of 1,024 slots per score_gate grid step in JAX; read by no port
    # dispatch (the CUDA tile is fixed)
    score_block_rows: int = 16
    # events fused per ingest call in JAX when a query micro-batch is cut
    # into ``EngineConfig.ingest_quantum`` slices (0: one call a slice);
    # read by no port dispatch (one call a slice)
    ingest_chunk: int = 0
    # provenance (not consulted by dispatch)
    backend: str = ""
    shape_class: str = ""

    def __post_init__(self):
        for op in HOT_PATH_OPS:
            v = getattr(self, op)
            if v not in (KERNEL, JNP):
                raise ValueError(f"plan.{op} must be 'kernel' or 'jnp', "
                                 f"got {v!r}")

    def uses_kernel(self, op: str) -> bool:
        if op not in HOT_PATH_OPS:
            raise KeyError(f"unknown hot path {op!r}")
        return getattr(self, op) == KERNEL

    def variants(self) -> Dict:
        """op -> variant, plus the two knobs, for metrics surfaces."""
        d = {op: getattr(self, op) for op in HOT_PATH_OPS}
        d["score_block_rows"] = self.score_block_rows
        d["ingest_chunk"] = self.ingest_chunk
        return d

    # ---- serialization (disk cache + snapshot meta) ----
    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "TunedPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def dumps(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @classmethod
    def loads(cls, s: str) -> "TunedPlan":
        return cls.from_json(json.loads(s))


#: The all-jnp plan: every hot path on its plain twin (the CPU's route).
JNP_PLAN = TunedPlan()


def all_kernel_plan(**overrides) -> TunedPlan:
    """Every hot path through its kernel (the CUDA route)."""
    kw = {op: KERNEL for op in HOT_PATH_OPS}
    kw.update(overrides)
    return TunedPlan(**kw)


def device_route(device) -> str:
    """The variant every hot path runs on ``device``: its kernel on CUDA,
    its plain twin on the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return KERNEL
    if kind == "cpu":
        return JNP
    raise RuntimeError(f"no kernel route for device {device}")


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


def shape_class(cfg, device="cuda") -> str:
    """The autotune cache key: the same string means the same cached plan
    applies. The device type and kind (``torch.cuda.get_device_name``,
    lower-cased and dashed as JAX's device kind), log2 store capacities,
    cooc layout and region width."""
    device = torch.device(device)
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = device.type
    dk = str(kind).replace(" ", "-").replace("/", "-").lower()
    parts = [device.type, dk,
             f"q{cfg.query_capacity.bit_length() - 1}",
             f"c{cfg.cooc_capacity.bit_length() - 1}",
             f"s{cfg.session_capacity.bit_length() - 1}",
             cfg.cooc_layout]
    if cfg.cooc_layout == "region":
        parts.append(f"w{cfg.region_w}")
    return "-".join(parts)

"""Hand-written Hopper kernels for the engine's hot loops, with plain twins.

Dispatch policy (the one place it is decided)
---------------------------------------------

Every kernel wrapper in this package routes on the device of the tensors it
is given, through :func:`route`:

  * a CUDA tensor goes through the hand-written CUDA kernel (``csrc/``,
    built by :mod:`.build` at first use). If the kernel cannot be built or
    launched, the wrapper raises; there is no fallback;
  * a CPU tensor goes through the kernel's plain torch version (``ref.py``),
    which is also the oracle the kernel is held against on the card;
  * any other device raises.

No flag routes CUDA work to the plain version.

Each wrapper adds one to its entry in :data:`LAUNCHES` where it launches its
kernel, and nowhere else, so a run can show that the main path went through
the kernels.

Kernel sites::

    call site                                  wrapper                  kernel (csrc/)
    ------------------------------------------ ------------------------ ----------------
    core/decay.sweep_decay_prune               ops.decay_prune_table    decay_prune.cu
    (no engine caller)                         decay_prune.decay_prune  decay_prune.cu
    core/ranking._score_and_gate               ops.score_gate           score_gate.cu
    core/ranking.ranking_cycle (selection)     ops.bucket_topk          bucket_topk.cu
    core/stores.region_insert_accumulate,      ops.chain_find           chain_find.cu
      core/stores.region_lookup
    core/ranking.ranking_cycle_region (grid)   ops.region_rank          region_rank.cu
    core/ranking.ranking_cycle_region (merge)  ops.bucket_topk          bucket_topk.cu
    core/spelling.spelling_cycle               ops.edit_distance        edit_distance.cu
    models/layers.attention (cache-free)       ops.flash_attention      flash_attention.cu
    (no engine caller)                         ops.assoc_score          assoc_score.cu
    (no engine caller)                         region_probe.            chain_find.cu
                                                 chain_find_depth

The hash layout's path runs ``decay_prune_multi``, ``score_gate`` and
``bucket_topk``; the region layout's runs ``decay_prune_multi`` (the
qstore sweep), ``chain_find``, ``region_rank`` and ``bucket_topk``
(:data:`PATH_KERNELS`). The spelling job runs ``edit_distance``; the LM's
cache-free forward, dense or MoE, runs ``flash_attention`` once per layer
(its prefill and decode go through the KV cache in plain torch, as in JAX;
the MoE layer is plain torch, as it is ``jnp`` in JAX). An LM's train
step runs ``flash_attention``'s forward once per layer, and once more per
layer under remat ``"full"`` (the recomputed forward); its backward is the
plain twin under autograd, as JAX's ``custom_vjp`` backward is its jnp
oracle. The recsys and GNN serving and training paths launch none: no
Pallas kernel lies on them in JAX either (``jnp.take``, einsums, segment
ops and ``lax.top_k``). A job of the §3 batch baseline
(``data/batch_pipeline.py``) is a fresh hash engine with decay off that
re-ingests its window and ranks once: ``score_gate`` and ``bucket_topk``.
The single-lane entries ``decay_prune.decay_prune`` and
``region_probe.chain_find_depth`` launch ``decay_prune_multi``'s and
``chain_find``'s kernels and count under those names.
"""
from __future__ import annotations

from typing import Dict

import torch

KERNELS = ("decay_prune_multi", "score_gate", "bucket_topk", "chain_find",
           "region_rank", "assoc_score", "edit_distance", "flash_attention")

# The kernels each cooc layout's main path, the spelling job, the dense
# and MoE LMs' scoring forwards, the recsys and GNN serving paths, an
# LM's train step and a batch-baseline job launch.
PATH_KERNELS = {
    "hash": ("decay_prune_multi", "score_gate", "bucket_topk"),
    "region": ("decay_prune_multi", "chain_find", "region_rank",
               "bucket_topk"),
    "spelling": ("edit_distance",),
    "lm": ("flash_attention",),
    "moe": ("flash_attention",),
    "recsys": (),
    "gnn": (),
    "train": ("flash_attention",),
    "batch": ("score_gate", "bucket_topk"),
}

# Launch counts per kernel: incremented only where a wrapper launches its
# CUDA kernel (never for the plain version on the CPU).
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def route(*tensors: torch.Tensor) -> str:
    """``"kernel"`` for CUDA tensors, ``"plain"`` for CPU tensors.

    All tensors must share one device; any other device raises.
    """
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return "kernel"
    if dev.type == "cpu":
        return "plain"
    raise RuntimeError(f"no kernel route for device {dev}")


def check_launch(code: int, name: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")

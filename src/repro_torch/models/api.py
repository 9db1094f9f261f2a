"""Architecture API, LM serving half: port of the JAX package's
``models/api.py`` for the dense and MoE LMs' prefill and decode cells.

  * ``ShapeCell`` / ``ArchSpec``      — one (architecture x input shape) cell
  * ``serve_fn(cfg, cell)``            — the step for a prefill or decode cell
  * ``make_inputs(rng, cfg, cell)``    — random tokens and fresh caches
  * ``adapt_lm_config(cfg, cell, dp)`` — MoE dispatch groups for a cell

GNN and recsys models, and training cells, are not ported yet (ROADMAP
Queue 1 items 14.3 and 14.4) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.stores import resolve_device
from . import transformer as tr

PENDING = "not ported yet (ROADMAP Queue 1 item 14)"


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) cell of the assignment matrix."""
    name: str
    kind: str                      # train | prefill | decode | serve | retrieval
    dims: Dict[str, int]
    skip: Optional[str] = None     # reason if inapplicable (recorded, not run)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys
    model: str                     # lm | gat | bst | xdeepfm | bert4rec | twotower
    config: Any
    smoke_config: Any
    shapes: Tuple[ShapeCell, ...]
    source: str = ""

    def cell(self, name: str) -> ShapeCell:
        for c in self.shapes:
            if c.name == name:
                return c
        raise KeyError(name)


def _lm_serving(cfg, cell: ShapeCell) -> None:
    if not isinstance(cfg, tr.LMConfig):
        raise NotImplementedError(f"{type(cfg).__name__} models are {PENDING}")
    if cell.kind not in ("prefill", "decode"):
        raise NotImplementedError(f"{cell.kind} cells are {PENDING}")


def serve_fn(cfg, cell: ShapeCell) -> Callable:
    """Forward-only step for a prefill or decode cell:
    ``fn(params, caches, tokens) -> (logits, caches)``."""
    _lm_serving(cfg, cell)
    if cell.kind == "prefill":
        return lambda p, caches, tokens: tr.prefill(p, tokens, cfg, caches)
    return lambda p, caches, tokens: tr.decode_step(p, tokens, cfg, caches)


def adapt_lm_config(cfg: tr.LMConfig, cell: ShapeCell, dp_size: int = 1
                    ) -> tr.LMConfig:
    """Per-cell config tweaks: MoE dispatch groups must divide the token
    count and align with the data-parallel axis (one card: ``dp_size``
    1, so one group)."""
    if not isinstance(cfg, tr.LMConfig) or cfg.moe is None:
        return cfg
    d = cell.dims
    n_tok = d["batch"] * d["seq"] if cell.kind in ("train", "prefill") \
        else d["batch"]
    g = dp_size
    while g > 1 and n_tok % g:
        g -= 1
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=g))


def make_inputs(rng: np.random.Generator, cfg, cell: ShapeCell,
                device="cuda") -> Dict:
    """``{"caches", "tokens"}`` for a prefill ([B, seq] tokens) or decode
    ([B, 1]) cell: token ids drawn as the JAX ``make_inputs`` draws them
    (integers below 100, mod the vocabulary) and fresh caches of
    ``cache_len`` (default ``seq``). The JAX function also draws values for
    the caches it then discards, so the ids are not draw-for-draw its."""
    _lm_serving(cfg, cell)
    device = resolve_device(device)
    d = cell.dims
    shape = (d["batch"], d["seq"] if cell.kind == "prefill" else 1)
    tokens = rng.integers(0, 100, shape) % cfg.vocab_size
    return {"caches": tr.init_caches(cfg, d["batch"],
                                     d.get("cache_len", d["seq"]), device),
            "tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)}

"""Architecture registry: ``get_arch(arch_id)`` / ``list_archs()``.

Copies of the JAX package's ten configs: the dense and MoE LMs, the GAT
and the four recsys models."""
from __future__ import annotations

from importlib import import_module
from typing import List

from ..models.api import ArchSpec

_ARCH_MODULES = {
    "granite-3-8b": "granite_3_8b",
    "qwen3-8b": "qwen3_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "gat-cora": "gat_cora",
    "bst": "bst",
    "xdeepfm": "xdeepfm",
    "bert4rec": "bert4rec",
    "two-tower-retrieval": "two_tower_retrieval",
}


def get_arch(arch_id: str) -> ArchSpec:
    mod = import_module(f".{_ARCH_MODULES[arch_id]}", __package__)
    return mod.SPEC


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)

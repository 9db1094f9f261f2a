"""Architecture registry: ``get_arch(arch_id)`` / ``list_archs()``.

Copies of the JAX package's configs for the architectures the port runs
(the dense and MoE LMs). The others (GNN, recsys) raise until their slice
is ported.
"""
from __future__ import annotations

from importlib import import_module
from typing import List

from ..models.api import PENDING, ArchSpec

_ARCH_MODULES = {
    "granite-3-8b": "granite_3_8b",
    "qwen3-8b": "qwen3_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
}
_NOT_PORTED = ("gat-cora", "bst", "xdeepfm", "bert4rec",
               "two-tower-retrieval")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(f"{arch_id} is {PENDING}")
    mod = import_module(f".{_ARCH_MODULES[arch_id]}", __package__)
    return mod.SPEC


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)

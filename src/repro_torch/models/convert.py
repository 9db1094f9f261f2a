"""Carry parameters between the JAX package's tree and the port's module.

The JAX tree is ``{"embed", "blocks": {...stacked on a leading layer
dim...}, "norm_f", "lm_head"}``; :func:`params_from_jax` takes it as numpy
arrays (bf16 leaves as the ``bfloat16`` numpy dtype JAX hands out, or any
other dtype, each cast to the dtype of the parameter it loads into: an MoE
router stays f32 in a bf16 model) and unstacks ``blocks`` into the
module's per-layer blocks. :func:`moe_from_jax` loads one ``init_moe``
tree. :func:`params_to_numpy` goes the other way, for the tests.

The GAT and recsys trees nest dicts and lists (``blocks``, ``cin``,
``layers``); :func:`model_from_jax` loads one into the config's module
(``blocks.0.wq``, ``cin.0``, ``layers.1.w``, ...) and
:func:`model_to_numpy` gives the tree back.

A trainer's ``(params, train_state)`` goes both ways too:
:func:`train_leaves` lists it as ``jax.tree.leaves((params, state))``
lists the JAX trainer's (an LM's block leaves stacked, the optimizer state
after the parameters in JAX's key order), and :func:`load_train_leaves`
writes such a list, from either trainer, into the port's module and state.
A checkpoint of that list written by either trainer restores in the other.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..core.stores import resolve_device
from ..training import optimizer as optim
from . import api
from .moe import MoE, MoEConfig
from .transformer import LM, LMConfig


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)   # a writable copy
    if a.dtype.name == "bfloat16":   # no numpy bf16 in torch: go by bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _flat(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) \
        else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _load(module: nn.Module, flat: Dict[str, np.ndarray], device):
    """Fill ``module`` from ``flat``, each value cast to its parameter's
    dtype; every parameter must be named once."""
    dtypes = {n: t.dtype for n, t in module.state_dict().items()}
    module.load_state_dict({n: _tensor(a, dtypes[n], device)
                            for n, a in flat.items()}, strict=True)
    return module


def params_from_jax(np_params, cfg: LMConfig, device="cuda") -> LM:
    """The port's module holding the JAX parameter tree's values."""
    device = resolve_device(device)
    flat = {}
    for name, a in _flat(np_params).items():
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(cfg.n_layers):
                flat[f"blocks.{i}.{rest}"] = np.asarray(a)[i]
        else:
            flat[name] = a
    return _load(LM(cfg, device), flat, device)


def moe_from_jax(np_params, d_model: int, cfg: MoEConfig, dtype,
                 device="cuda") -> MoE:
    """The port's MoE module holding one JAX ``init_moe`` tree's values."""
    device = resolve_device(device)
    return _load(MoE(d_model, cfg, dtype, device), _flat(np_params), device)


def params_to_numpy(model: LM) -> Dict:
    """The JAX-shaped tree of numpy arrays (``blocks`` stacked again, an
    MoE block's under ``blocks/moe``, its shared experts under
    ``blocks/moe/shared``); bf16 leaves come back as float32."""
    tree: Dict = {}
    stacked: Dict[str, list] = {}
    for name, t in model.state_dict().items():
        a = t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()
        if name.startswith("blocks."):
            _, _, rest = name.split(".", 2)
            stacked.setdefault(rest, []).append(a)
        else:
            tree[name] = a
    for rest, arrs in stacked.items():
        node = tree.setdefault("blocks", {})
        *path, leaf = rest.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.stack(arrs)
    return tree


def model_from_jax(np_params, cfg, device="cuda") -> nn.Module:
    """A GAT or recsys config's module holding the JAX tree's values."""
    device = resolve_device(device)
    module = api.init_params(cfg, generator=None, device=device)
    return _load(module, _flat(np_params), device)


def model_to_numpy(module: nn.Module):
    """The JAX-shaped tree of a GAT or recsys module: dicts, with a list
    where the names run 0, 1, ..."""
    tree: Dict = {}
    for name, t in module.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def _runs(params):
    """Each JAX leaf as (indices into ``optimizer.leaves``, stacked?)."""
    stacked = getattr(params, "STACKED", None)
    named = optim.named_leaves(params)
    return [(run, named[run[0]][0].split(".")[0] == stacked)
            for run in optim.groups(params)]


def _state_lists(state) -> List:
    """The state's leaf lists and tensors in JAX's key order ("ef", then
    "opt": "m", "master", "step", "v")."""
    out = []
    for key in sorted(state):
        node = state[key]
        if isinstance(node, dict):
            out += [node[k] for k in sorted(node)]
        else:
            out.append(node)
    return out


def jax_leaves(params, tensors) -> List[torch.Tensor]:
    """``tensors`` (one a leaf of ``optimizer.leaves(params)``: the
    parameters, their gradients or a moment) as the JAX tree's leaves, an
    LM's block leaves stacked (new tensors; the others detached views)."""
    return [torch.stack([tensors[i].detach() for i in run]) if st
            else tensors[run[0]].detach() for run, st in _runs(params)]


def train_leaves(params, state) -> List[torch.Tensor]:
    """``(params, train_state)`` in ``jax.tree.leaves`` order of the JAX
    trainer's (see :func:`jax_leaves`)."""
    out = jax_leaves(params, optim.leaves(params))
    for node in _state_lists(state):
        out += jax_leaves(params, node) if isinstance(node, list) \
            else [node]
    return out


@torch.no_grad()
def load_train_leaves(params, state, leaves) -> None:
    """Write ``leaves`` (:func:`train_leaves` order: torch tensors, or
    numpy arrays as the JAX trainer's hold them, bf16 included) into
    ``params`` and ``state`` in place, each cast to its tensor's dtype."""
    runs = _runs(params)
    targets = [optim.leaves(params)] + _state_lists(state)
    n_want = sum(len(runs) if isinstance(t, list) else 1 for t in targets)
    if len(leaves) != n_want:
        raise ValueError(f"{len(leaves)} leaves for a train state of "
                         f"{n_want}")
    it = iter(leaves)

    def put(dst, a):
        dst.copy_(a if isinstance(a, torch.Tensor)
                  else _tensor(a, dst.dtype, dst.device))
    for node in targets:
        if not isinstance(node, list):
            put(node, next(it))
            continue
        for run, st in runs:
            a = next(it)
            for j, i in enumerate(run):
                put(node[i], a[j] if st else a)

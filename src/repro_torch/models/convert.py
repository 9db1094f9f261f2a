"""Carry parameters between the JAX package's tree and the port's module.

The JAX tree is ``{"embed", "blocks": {...stacked on a leading layer
dim...}, "norm_f", "lm_head"}``; :func:`params_from_jax` takes it as numpy
arrays (bf16 leaves as the ``bfloat16`` numpy dtype JAX hands out, or any
other dtype, cast to the config's) and unstacks ``blocks`` into the
module's per-layer blocks. :func:`params_to_numpy` goes the other way, for
the tests.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.stores import resolve_device
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
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_jax(np_params, cfg: LMConfig, device="cuda") -> LM:
    """The port's module holding the JAX parameter tree's values."""
    device = resolve_device(device)
    model = LM(cfg, device)
    dt = cfg.torch_dtype
    state = {}
    for name, a in _flat(np_params).items():
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(cfg.n_layers):
                state[f"blocks.{i}.{rest}"] = _tensor(np.asarray(a)[i], dt,
                                                      device)
        else:
            state[name] = _tensor(a, dt, device)
    model.load_state_dict(state, strict=True)
    return model


def params_to_numpy(model: LM) -> Dict:
    """The JAX-shaped tree of numpy arrays (``blocks`` stacked again); bf16
    leaves come back as float32."""
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

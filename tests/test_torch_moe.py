"""The PyTorch port's mixture-of-experts FFN (CPU) against the JAX package's.

Inputs are made with numpy from a seed; the JAX ``init_moe`` parameters are
carried across by ``convert.moe_from_jax``. JAX's dispatch is read off the
real function: ``moe.py`` hands its masked dispatch buffer ``h_in`` to
``constrain`` (a no-op without a mesh), so a spy in its place sees which
token fills each slot (the token rows are distinct, so each slot's row names
its token; an empty slot is a zero row).

Bars, and why:

  * the dispatch (each slot's token) and the kept and dropped counts are
    exact: both sides route the same logits by the same rules;
  * ``out`` within rtol = atol = 1e-5 in f32: the only difference is the
    order of sums in the matmuls (XLA's einsums against torch's bmm, ~1e-7
    relative per op);
  * ``aux`` within 1e-6 (means of probabilities, summed in another order);
  * bf16: ``out`` within the LM tests' bf16 bar of 2e-2 (both round the
    same products to bf16; a value near a rounding boundary flips by one
    bf16 ulp, 2^-8 relative).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from repro_torch.models.convert import moe_from_jax


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """XLA:CPU's compiled executables hold memory maps of the worker
    process, which count against its map limit; the tier-1 run's
    JAX-heavy workers come close to it, so this file releases its own."""
    yield
    jax.clear_caches()


D = 64
BASE = moe.MoEConfig(n_experts=6, top_k=2, d_ff=32)
CASES = {
    "g1": {},
    "g2": {"groups": 2},
    "cap0.5": {"capacity_factor": 0.5},
    "cap0.5-g2": {"capacity_factor": 0.5, "groups": 2},
    "shared": {"n_shared_experts": 2, "shared_d_ff": 16},
    "shared-g2-cap0.5": {"n_shared_experts": 1, "shared_d_ff": 48,
                         "groups": 2, "capacity_factor": 0.5},
    "top3": {"top_k": 3, "n_experts": 8},
}


def _jcfg(cfg: moe.MoEConfig) -> jmoe.MoEConfig:
    return jmoe.MoEConfig(**dataclasses.asdict(cfg))


def _params(cfg, dtype, zero_router=False, seed=0):
    """JAX init_moe parameters (numpy tree) and the port's module."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, _jcfg(cfg),
                       getattr(jnp, dtype))
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tree = jax.tree.map(np.asarray, jp)
    return jp, moe_from_jax(tree, D, cfg, getattr(torch, dtype), device="cpu")


def _x(B=2, T=24, seed=3):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(
        np.float32)


def _jax_moe(jp, x, cfg, monkeypatch):
    """(out, aux, slot_tok [G, E*C]) of the JAX function, the dispatch read
    off the buffer it hands ``constrain``."""
    seen = []

    def spy(a, *axes):
        seen.append(a)
        return a
    monkeypatch.setattr(jmoe, "constrain", spy)
    out, aux = jmoe.moe_ffn(jp, x, _jcfg(cfg))
    xf = np.asarray(seen[0], np.float32)                   # (G, Ng, d)
    G, E = xf.shape[0], cfg.n_experts
    h_in = np.asarray(seen[1], np.float32).reshape(G, -1, D)  # (G, E*C, d)
    match = (h_in[:, :, None, :] == xf[:, None, :, :]).all(-1)
    assert (match.sum(-1) <= 1).all(), "token rows are not distinct"
    slot_tok = np.where(match.any(-1), match.argmax(-1), -1)
    assert slot_tok.shape[1] % E == 0
    return out, aux, slot_tok


def _check(cfg, x_np, dtype, monkeypatch, zero_router=False):
    jp, tp = _params(cfg, dtype, zero_router)
    jx = jnp.asarray(x_np, getattr(jnp, dtype))
    tx = torch.from_numpy(x_np).to(getattr(torch, dtype))
    j_out, j_aux, j_slot = _jax_moe(jp, jx, cfg, monkeypatch)

    G = cfg.groups
    xf = tx.reshape(G, -1, D)
    r = moe.route(xf.float() @ tp.router, cfg)
    np.testing.assert_array_equal(r.slot_tok.numpy(), j_slot)
    n_assign = x_np.shape[0] * x_np.shape[1] * cfg.top_k
    j_kept = int((j_slot >= 0).sum())
    assert int(r.n_kept) == j_kept
    assert int(r.n_dropped) == n_assign - j_kept
    out, aux = moe.moe_ffn(tp, tx, cfg)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=0, atol=1e-6)
    return r


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case, monkeypatch):
    cfg = dataclasses.replace(BASE, **CASES[case])
    r = _check(cfg, _x(), "float32", monkeypatch)
    if cfg.capacity_factor < 1:
        assert int(r.n_dropped) > 0   # the capacity binds on both sides


@pytest.mark.parametrize("groups", [1, 2])
def test_zero_router_ties_go_to_the_lowest_experts(groups, monkeypatch):
    """Every logit ties: each token picks experts 0..k-1 (``lax.top_k``'s
    rule), the rest of the experts stay empty and the capacity drops the
    overflow, equally on both sides."""
    cfg = dataclasses.replace(BASE, groups=groups)
    r = _check(cfg, _x(), "float32", monkeypatch, zero_router=True)
    C, E = r.C, cfg.n_experts
    filled = (r.slot_tok.view(groups, E, C) >= 0).any(-1)
    assert filled[:, :cfg.top_k].all() and not filled[:, cfg.top_k:].any()
    assert int(r.n_dropped) == 2 * 24 * cfg.top_k - groups * cfg.top_k * C


@pytest.mark.parametrize("case", ["g1", "shared-g2-cap0.5"])
def test_moe_ffn_bf16_matches_jax(case, monkeypatch):
    cfg = dataclasses.replace(BASE, **CASES[case])
    _check(cfg, _x(), "bfloat16", monkeypatch)


def test_capacity_and_groups():
    cfg = moe.MoEConfig(n_experts=60, top_k=4, d_ff=1408)
    # qwen2-moe-a2.7b at 4 x 4,096 tokens; a decode step of 4 tokens
    assert moe.capacity(cfg, 4 * 4096) == 1368
    assert moe.capacity(cfg, 4) == 8
    cfg2 = dataclasses.replace(cfg, groups=3)
    x = torch.zeros((2, 5, 8))
    with pytest.raises(ValueError, match="not divisible by groups"):
        moe.moe_ffn(moe.MoE(8, cfg2, torch.float32, "cpu"), x, cfg2)


def test_init_moe_matches_jax_shapes_dtypes_and_spread():
    """The same tree, shapes and dtypes (the router f32 in a bf16 MoE), and
    per tensor the same std within 5 standard errors."""
    from repro_torch.models.convert import _flat
    cfg = dataclasses.replace(BASE, n_shared_experts=2, shared_d_ff=16)
    tp = moe.init_moe(D, cfg, torch.bfloat16,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    jp = _flat(jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(0), D, _jcfg(cfg), jnp.bfloat16)))
    got = dict(tp.state_dict())
    assert set(got) == set(jp)
    for name, t in got.items():
        e = jp[name]
        assert tuple(t.shape) == e.shape, name
        want = torch.float32 if name == "router" else torch.bfloat16
        assert t.dtype == want and e.dtype.name == str(want).split(".")[1]
        g = t.float().numpy()
        sd = float(e.astype(np.float32).std())
        assert abs(float(g.std()) - sd) <= 5 * sd / np.sqrt(2 * g.size), name

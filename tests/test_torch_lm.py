"""The PyTorch port's LM serving path (CPU) against the JAX package.

Inputs are made with numpy from a seed and handed to both; model weights
are the JAX package's ``init_params`` carried across by
``convert.params_from_jax``. The SMOKE configs are f32.

Tolerances, and why:

  * ``flash_attention_ref`` (the CUDA kernel's plain twin) against the JAX
    reference and the Pallas kernel (interpret mode): JAX's own bars from
    ``tests/test_kernels.py`` — 2e-4 in f32 (sums in another order), 2e-2
    in bf16 (both round the f32 result to bf16 once; a value near a rounding
    boundary flips by one bf16 ulp, 2^-8 relative);
  * its gradient against ``jax.grad`` of the JAX ``custom_vjp``: JAX's
    rtol 1e-3, atol 1e-4;
  * ``rms_norm``, ``apply_rope`` and the cache writes: within 1e-6 (the
    writes move values and must be exact);
  * whole models, f32: logits and cache k/v within rtol = atol = 1e-4. Both
    sides compute in f32 and differ only in summation order (XLA's CPU dots
    against torch's), ~1e-6 relative per op over two layers; 1e-4 leaves
    two decades and still fails on one wrong key in a 16-key window (a
    ~1/16 change of an attention row). Cache positions are exact. The MoE
    models' router loss (the mean over layers) within 1e-6, as
    ``tests/test_torch_moe.py`` holds one layer's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch, list_archs as j_list_archs
from repro.kernels import ops as jops
from repro.models import api as j_api
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import kv_cache as jkv
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch import kernels as tk
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import api, kv_cache, layers, transformer as tr
from repro_torch.models.convert import params_from_jax, params_to_numpy


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """XLA:CPU's compiled executables hold memory maps of the worker
    process, which count against its map limit; the tier-1 run's
    JAX-heavy workers come close to it, so this file releases its own."""
    yield
    jax.clear_caches()


ARCHS = ["h2o-danube-1.8b", "granite-3-8b", "qwen3-8b", "qwen2-moe-a2.7b",
         "mixtral-8x22b"]
SWEEP = [
    # (B, Hq, Hkv, Tq, Tk, D, causal, window): tests/test_kernels.py's sweep
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 8, 8, 128, 128, 16, True, 16),
    (2, 4, 1, 1, 64, 32, True, 0),       # decode: single query token
    (1, 2, 2, 37, 61, 8, False, 0),       # ragged, bidirectional
    (1, 4, 2, 96, 96, 64, True, 32),      # GQA + SWA
]
T_PROMPT, N_DECODE = 64, 4


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(shape, seed):
    B, Hq, Hkv, Tq, Tk, D, _, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]


# ---------------------------------------------------------------------------
# (a) the kernel's plain twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SWEEP, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_matches_jax_and_pallas(shape, dtype):
    causal, window = shape[6], shape[7]
    arrs = _qkv(shape, sum(shape[:6]))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    tq, tk_, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in arrs)
    got = ref.flash_attention_ref(tq, tk_, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    got = got.float().numpy()
    exp = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       window=window))
    pallas = _np(j_flash(jq, jk, jv, causal=causal, window=window,
                         block_q=32, block_k=32, interpret=True))
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, exp, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    # the wrapper on CPU tensors is the twin, and launches nothing
    tk.reset_launches()
    wrapped = flash_attention(tq, tk_, tv, causal=causal, window=window)
    assert torch.equal(wrapped, ref.flash_attention_ref(
        tq, tk_, tv, causal=causal, window=window))
    assert tk.LAUNCHES["flash_attention"] == 0


def test_flash_attention_refuses_rows_without_keys():
    """Causal Tq > Tk leaves the first rows with no key: the JAX reference
    gives NaN there and the Pallas kernel a block-size-dependent mean of v;
    the port's wrapper raises instead."""
    q, k, v = (torch.zeros(s) for s in ((1, 2, 8, 16), (1, 2, 4, 16),
                                        (1, 2, 4, 16)))
    with pytest.raises(ValueError, match="no valid key"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="no valid key"):
        ops.flash_attention(q, k, v, True, 0)
    assert flash_attention(q, k, v, causal=False).shape == q.shape


# ---------------------------------------------------------------------------
# (b) the gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2, 2, 32, 32, 16, True, 0),
                                   (1, 4, 2, 48, 48, 16, True, 8)], ids=str)
def test_flash_attention_grad_matches_jax_custom_vjp(shape):
    causal, window = shape[6], shape[7]
    arrs = _qkv(shape, 3)

    def f_j(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, causal, window) ** 2)
    g_j = jax.grad(f_j, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (ops.flash_attention(*ts, causal, window) ** 2).sum().backward()
    for t, g in zip(ts, g_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# (c) layers and caches
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    exp = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                               atol=1e-6)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    for theta in (10000.0, 1e6):
        got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta)
        exp = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("window", [0, 8])
def test_cache_write_and_update_and_read_match_jax(window):
    """Three writes: a prompt longer than the ring, one decode token, and a
    full cache's write past its end (dropped)."""
    B, T_max, H, D = 2, 12, 2, 4
    rng = np.random.default_rng(window)
    tc = kv_cache.init_cache(B, T_max, H, D, torch.float32, window=window,
                             device="cpu")
    jc = jkv.init_cache(B, T_max, H, D, jnp.float32, window=window)
    start = 0
    for step, T in enumerate((10, 1, 5)):
        k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                for _ in range(2))
        pos = np.broadcast_to(np.arange(start, start + T, dtype=np.int32),
                              (B, T)).copy()
        start += T
        args_t = (torch.from_numpy(k), torch.from_numpy(v),
                  torch.from_numpy(pos))
        args_j = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        if step == 1:
            np.testing.assert_array_equal(
                kv_cache.cache_read_state(tc)[0].numpy(),
                np.asarray(jkv.cache_read_state(jc)[0]))
            tc = kv_cache.cache_write(tc, *args_t)
            jc = jkv.cache_write(jc, *args_j)
        else:
            got = kv_cache.cache_update_and_read(tc, *args_t)
            exp = jkv.cache_update_and_read(jc, *args_j)
            tc, jc = got[4], exp[4]
            for g, e in zip(got[:4], exp[:4]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        for name in ("k", "v", "pos", "window"):
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))


# ---------------------------------------------------------------------------
# (d) whole models
# ---------------------------------------------------------------------------

def _models(arch, **changes):
    jcfg = dataclasses.replace(j_get_arch(arch).smoke_config, **changes)
    tcfg = dataclasses.replace(get_arch(arch).smoke_config, **changes)
    jparams = jtr.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, B=2, T=T_PROMPT, seed=11):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _close(got, exp, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(exp), rtol=1e-4,
                               atol=1e-4, err_msg=what)


@pytest.mark.parametrize("arch,changes", [
    *[(a, {}) for a in ARCHS],
    ("h2o-danube-1.8b", {"vocab_size": 500}),   # padded vocab rows masked
], ids=lambda x: x if isinstance(x, str) else "-".join(
    f"{k}{v}" for k, v in x.items()))
def test_forward_matches_jax_with_and_without_pallas(arch, changes):
    jcfg, jparams, tcfg, tparams = _models(arch, **changes)
    toks = _tokens(tcfg)
    tk.reset_launches()
    got, caches, aux = tr.forward(tparams, torch.from_numpy(toks), tcfg)
    assert caches is None
    assert tk.LAUNCHES["flash_attention"] == 0   # CPU: the plain twin
    for pallas in (False, True):
        cfg = dataclasses.replace(jcfg, use_pallas_attention=pallas)
        exp, _, j_aux = jtr.forward(jparams, jnp.asarray(toks), cfg)
        _close(got.numpy(), exp, f"logits, use_pallas_attention={pallas}")
        np.testing.assert_allclose(float(aux), float(j_aux), rtol=0,
                                   atol=1e-6)
    assert (aux == 0.0) == (tcfg.moe is None)
    if tcfg.padded_vocab != tcfg.vocab_size:
        assert (got[..., tcfg.vocab_size:] < -1e29).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 64 tokens (danube: four chunks of its 16-token window, so
    the ring wraps and the window binds), then 4 greedy decode steps:
    logits and every cache leaf after each call."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    B = 2
    toks = _tokens(tcfg, B)
    cache_len = T_PROMPT + N_DECODE
    tcache = tr.init_caches(tcfg, B, cache_len, device="cpu")
    jcache = jtr.init_caches(jcfg, B, cache_len)

    def check_caches(what):
        for name in ("k", "v"):
            _close(tcache[name].numpy(), jcache[name], f"{what}: cache {name}")
        for name in ("pos", "window"):
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))

    got, tcache = tr.prefill(tparams, torch.from_numpy(toks), tcfg, tcache)
    exp, jcache = jtr.prefill(jparams, jnp.asarray(toks), jcfg, jcache)
    _close(got.numpy(), exp, "prefill logits")
    check_caches("prefill")
    nxt = np.array(exp[:, -1].argmax(-1), np.int32)[:, None]
    for step in range(N_DECODE):
        got, tcache = tr.decode_step(tparams, torch.from_numpy(nxt), tcfg,
                                     tcache)
        exp, jcache = jtr.decode_step(jparams, jnp.asarray(nxt), jcfg, jcache)
        _close(got.numpy(), exp, f"decode step {step} logits")
        check_caches(f"decode step {step}")
        nxt = np.array(exp.argmax(-1), np.int32)[:, None]
    assert int(tcache["pos"][0, 0]) == T_PROMPT + N_DECODE


def test_serve_fn_and_make_inputs_drive_prefill_and_decode():
    spec = get_arch("h2o-danube-1.8b")
    cfg = spec.smoke_config
    params = tr.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    pre = api.ShapeCell("p", "prefill", {"batch": 2, "seq": 32,
                                         "cache_len": 40})
    dec = api.ShapeCell("d", "decode", {"batch": 2, "seq": 32,
                                        "cache_len": 40})
    inp = api.make_inputs(rng, cfg, pre, device="cpu")
    assert inp["tokens"].shape == (2, 32) and inp["caches"]["k"].shape == (
        cfg.n_layers, 2, cfg.window, cfg.n_kv_heads, cfg.hd)
    logits, caches = api.serve_fn(cfg, pre)(params, inp["caches"],
                                            inp["tokens"])
    assert logits.shape == (2, cfg.window, cfg.padded_vocab)
    step = api.make_inputs(rng, cfg, dec, device="cpu")["tokens"]
    assert step.shape == (2, 1)
    logits, caches = api.serve_fn(cfg, dec)(params, caches, step)
    assert logits.shape == (2, cfg.padded_vocab)
    assert caches["pos"].tolist() == [[33, 33]] * cfg.n_layers
    assert torch.isfinite(logits).all()
    # an LM train cell has no serving step (ValueError, as in JAX); its
    # inputs are [B, seq + 1] tokens, JAX's draw for draw; a GNN has no
    # serving step and an unknown config none either (TypeError, as in JAX)
    train = api.ShapeCell("t", "train", {"batch": 2, "seq": 32})
    with pytest.raises(ValueError, match="train"):
        api.serve_fn(cfg, spec.cell("train_4k"))
    with pytest.raises(ValueError, match="train"):
        j_api.serve_fn(j_get_arch("h2o-danube-1.8b").smoke_config,
                       j_api.ShapeCell("t", "train", {"batch": 2, "seq": 32}))
    got = api.make_inputs(np.random.default_rng(3), cfg, train,
                          device="cpu")["batch"]["tokens"]
    exp = j_api.make_inputs(np.random.default_rng(3),
                            j_get_arch("h2o-danube-1.8b").smoke_config,
                            j_api.ShapeCell("t", "train", {"batch": 2,
                                                           "seq": 32}))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(exp["batch"]["tokens"]))
    with pytest.raises(TypeError):
        api.serve_fn(get_arch("gat-cora").smoke_config, pre)
    with pytest.raises(TypeError):
        api.serve_fn(object(), pre)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b"])
def test_serve_fn_drives_moe_models_like_jax(arch):
    """An MoE model through ``adapt_lm_config``, ``make_inputs`` and
    ``serve_fn``: prefill then one decode step, against the JAX model on the
    same weights and tokens (f32, 1e-4)."""
    spec = get_arch(arch)
    jspec = j_get_arch(arch)
    pre = api.ShapeCell("p", "prefill", {"batch": 2, "seq": 32,
                                         "cache_len": 40})
    dec = api.ShapeCell("d", "decode", {"batch": 2, "seq": 32,
                                        "cache_len": 40})
    for dp in (1, 2, 3):
        for cell in (pre, dec):
            assert api.adapt_lm_config(spec.smoke_config, cell, dp).moe \
                .groups == j_api.adapt_lm_config(jspec.smoke_config, cell,
                                                 dp).moe.groups
    cfg = api.adapt_lm_config(spec.smoke_config, pre, dp_size=2)
    assert cfg.moe.groups == 2
    jcfg = j_api.adapt_lm_config(jspec.smoke_config, pre, dp_size=2)
    jparams = jtr.init_params(jax.random.PRNGKey(7), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    inp = api.make_inputs(np.random.default_rng(0), cfg, pre, device="cpu")
    logits, caches = api.serve_fn(cfg, pre)(params, inp["caches"],
                                            inp["tokens"])
    exp, jcache = j_api.serve_fn(jcfg, pre)(
        jparams, jtr.init_caches(jcfg, 2, 40), jnp.asarray(inp["tokens"]))
    _close(logits.numpy(), exp, "prefill logits")
    step = torch.from_numpy(np.array(exp[:, -1].argmax(-1), np.int32)[:, None])
    logits, caches = api.serve_fn(cfg, dec)(params, caches, step)
    exp, _ = j_api.serve_fn(jcfg, dec)(jparams, jcache, jnp.asarray(step))
    _close(logits.numpy(), exp, "decode logits")


# ---------------------------------------------------------------------------
# (e) configs and initialisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_configs(arch):
    assert set(ARCHS) <= set(list_archs()) and list_archs() == j_list_archs()
    t, j = get_arch(arch), j_get_arch(arch)
    for attr in ("arch_id", "family", "model", "source"):
        assert getattr(t, attr) == getattr(j, attr)
    assert [dataclasses.asdict(c) for c in t.shapes] == \
        [dataclasses.asdict(c) for c in j.shapes]
    for tc, jc in ((t.config, j.config), (t.smoke_config, j.smoke_config)):
        tf = dataclasses.asdict(tc)
        jf = dataclasses.asdict(jc)
        assert jf.pop("use_pallas_attention") is False
        assert tf == jf
        assert (tc.hd, tc.padded_vocab, tc.param_count()) == \
            (jc.hd, jc.padded_vocab, jc.param_count())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_jax_shapes_dtypes_and_spread(arch):
    """Same tree, shapes and dtypes; per tensor the same mean and std within
    5 standard errors of the estimates (std's relative standard error is
    1/sqrt(2n) for n samples; the mean's is std/sqrt(n)); ones exact."""
    tcfg = get_arch(arch).smoke_config
    jcfg = j_get_arch(arch).smoke_config
    tparams = tr.init_params(tcfg, generator=torch.Generator().manual_seed(1),
                             device="cpu")
    assert {p.dtype for n, p in tparams.named_parameters()
            if not n.endswith("moe.router")} == {tcfg.torch_dtype}
    bf16 = tr.init_params(dataclasses.replace(tcfg, dtype="bfloat16"),
                          generator=torch.Generator().manual_seed(1),
                          device="cpu")
    assert {n: p.dtype for n, p in bf16.named_parameters()
            if p.dtype != torch.bfloat16} == {
        f"blocks.{i}.moe.router": torch.float32
        for i in range(tcfg.n_layers) if tcfg.moe}
    got = jax.tree_util.tree_leaves_with_path(params_to_numpy(tparams))
    exp = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jtr.init_params(jax.random.PRNGKey(1),
                                                 jcfg))))
    assert len(got) == len(exp)
    for path, g in got:
        e = exp[path]
        assert g.shape == e.shape and g.dtype == e.dtype, path
        if np.all(e == 1):
            assert np.all(g == 1), path
            continue
        n = g[0].size if path[0].key == "blocks" else g.size
        for gl, el in (zip(g, e) if path[0].key == "blocks" else [(g, e)]):
            sd = float(el.std())
            assert abs(float(gl.std()) - sd) <= 5 * sd / np.sqrt(2 * n), path
            assert abs(float(gl.mean()) - float(el.mean())) <= \
                2 * 5 * sd / np.sqrt(n), path

"""The PyTorch port's recsys serving path (CPU) against the JAX package's.

Inputs are made with numpy from a seed; model weights are the JAX package's
``init_params(PRNGKey(0), cfg)`` carried across by
``convert.model_from_jax``. Every SMOKE config is f32. Each JAX serving
step is ``jax.jit``-ed once a config.

Bars, and why:

  * parameters, ``make_inputs`` and ``model_flops``/``model_bytes``: exact
    (copies of the same numbers, draws and arithmetic);
  * ``layer_norm``, ``mlp`` and ``embedding_bag``: rtol = atol = 1e-6
    (a handful of f32 ops on O(1) values, sums in another order);
  * BST, BERT4Rec and two-tower outputs: rtol = atol = 1e-5. Both sides
    compute in f32 and differ only in the order of sums (XLA's CPU dots
    against torch's), ~1e-7 relative per op over a few layers of width
    <= 128; the tower's unit vectors and the attention rows are O(1);
  * xDeepFM logits: rtol 1e-5, atol 1e-5 x max |logit|: the CIN's pooled
    sums run over Hk*m*D terms (SMOKE 16*8*6 = 768 a layer, 7,800 x 10
    at full width) whose cancellation leaves logits much smaller than the
    terms, so the bar scales with the output;
  * top-k values as above; the ids equal wherever a value stands more than
    the bar from its neighbours (where two scores lie within the bar,
    either order is right to f32); tied scores (duplicate rows) give the
    same ids in the same order as ``lax.top_k``: lowest index first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as j_get_arch, list_archs as j_list_archs
from repro.models import api as j_api
from repro.models import layers as jlayers
from repro.models import recsys as jrecsys
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import api, layers, recsys
from repro_torch.models.convert import model_from_jax, model_to_numpy


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """XLA:CPU's compiled executables hold memory maps of the worker
    process, which count against its map limit; the tier-1 run's
    JAX-heavy workers come close to it, so this file releases its own."""
    yield
    _CACHE.clear()
    jax.clear_caches()


RECSYS = ["bst", "xdeepfm", "bert4rec", "two-tower-retrieval"]
SERVE = api.ShapeCell("serve_smoke", "serve", {"batch": 24})
RETRIEVAL = api.ShapeCell("retr_smoke", "retrieval",
                          {"batch": 1, "n_candidates": 300})
# BERT4Rec serves its hierarchical top-k only past 100,000 items.
WIDE_BERT4REC = recsys.Bert4RecConfig(name="bert4rec-wide", n_items=150_000,
                                      embed_dim=16, n_blocks=1, n_heads=2,
                                      seq_len=8, d_ff=32)


def _jcfg(cfg):
    """The JAX config with the port config's fields."""
    kind = getattr(jrecsys, type(cfg).__name__)
    return kind(**dataclasses.asdict(cfg))


_CACHE = {}


def _models(cfg):
    """(JAX params, port module, jitted JAX serve per kind) for a config,
    made once."""
    if cfg not in _CACHE:
        jcfg = _jcfg(cfg)
        jp = j_api.init_params(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree.map(np.asarray, jp)
        fns = {}
        _CACHE[cfg] = (jp, tree, model_from_jax(tree, cfg, device="cpu"),
                       jcfg, fns)
    return _CACHE[cfg]


def _jserve(cfg, cell):
    jp, _, _, jcfg, fns = _models(cfg)
    if cell.kind not in fns:
        fns[cell.kind] = jax.jit(j_api.serve_fn(jcfg, cell))
    return fns[cell.kind](jp, {k: jnp.asarray(v) for k, v in
                               _np_batch(cfg, cell).items()})


def _np_batch(cfg, cell, seed=3):
    return {k: t.numpy() for k, t in api.make_inputs(
        np.random.default_rng(seed), cfg, cell, device="cpu")["batch"].items()}


def _serve(cfg, cell):
    batch = {k: torch.from_numpy(v) for k, v in _np_batch(cfg, cell).items()}
    return api.serve_fn(cfg, cell)(_models(cfg)[2], batch)


def _assert_topk(got, exp, bar=1e-5):
    """Values within ``bar``; ids equal wherever the value stands more than
    ``bar`` (relative) from each neighbour or ties it exactly on both sides
    (an exact tie breaks to the lowest index on both)."""
    gv, gi = (t.numpy() for t in got)
    ev, ei = (np.asarray(t) for t in exp)
    np.testing.assert_allclose(gv, ev, rtol=bar, atol=bar)
    tol = bar * np.maximum(np.abs(ev), 1.0)
    gap = np.diff(ev, axis=-1)
    ok = (np.abs(gap) > tol[..., 1:]) | ((gap == 0) & (np.diff(gv) == 0))
    clear = np.ones_like(ev, bool)
    clear[..., 1:] &= ok
    clear[..., :-1] &= ok
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(gi[clear], ei[clear])
    assert gi.dtype == np.int32


# ---------------------------------------------------------------------------
# registry, configs and parameters
# ---------------------------------------------------------------------------

def _fields(cfg, like):
    """The config's fields that ``like`` (the port's) has: the JAX LM config
    also has ``use_pallas_attention``, a switch of the JAX attention."""
    d = dataclasses.asdict(cfg)
    return {k: d[k] for k in dataclasses.asdict(like)}


def test_registry_lists_the_ten_jax_architectures():
    assert list_archs() == j_list_archs()
    for arch in list_archs():
        spec, jspec = get_arch(arch), j_get_arch(arch)
        assert (spec.arch_id, spec.family, spec.model, spec.source) == (
            jspec.arch_id, jspec.family, jspec.model, jspec.source)
        for c, jc in ((spec.config, jspec.config),
                      (spec.smoke_config, jspec.smoke_config)):
            assert dataclasses.asdict(c) == _fields(jc, c)
            if spec.family != "lm":
                assert dataclasses.asdict(c) == dataclasses.asdict(jc)
        assert [dataclasses.asdict(c) for c in spec.shapes] == [
            dataclasses.asdict(c) for c in jspec.shapes]


@pytest.mark.parametrize("arch", RECSYS)
def test_params_carried_across_by_convert(arch):
    """JAX's ``init_params`` tree into the port's module and back: the same
    names, nesting (lists where JAX has lists), shapes and values."""
    cfg = get_arch(arch).smoke_config
    _, tree, model, _, _ = _models(cfg)
    back = model_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    own = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    assert {n: t.shape for n, t in own.state_dict().items()} == {
        n: t.shape for n, t in model.state_dict().items()}


# ---------------------------------------------------------------------------
# inputs, FLOPs and bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(j_list_archs()))
def test_input_specs_match_jax(arch):
    """Every cell's input tree, shape and dtype for shape and dtype, at the
    full config (an LM's caches and its train cell's tokens too)."""
    spec, jspec = get_arch(arch), j_get_arch(arch)
    for cell, jcell in zip(spec.shapes, jspec.shapes):
        got = api.input_specs(spec.config, cell)
        exp = j_api.input_specs(jspec.config, jcell)
        flat = jax.tree_util.tree_flatten_with_path(exp)[0]
        assert len(flat) == len(jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, api.TensorSpec)))
        for path, s in flat:
            g = got
            for key in path:
                g = g[key.key]
            assert g.shape == s.shape, (cell.name, path)
            assert str(g.dtype) == f"torch.{s.dtype.name}", (cell.name, path)


@pytest.mark.parametrize("cell", ["train_batch", "serve_p99", "serve_bulk",
                                  "retrieval_cand"])
@pytest.mark.parametrize("arch", RECSYS)
def test_make_inputs_equal_jax_draw_for_draw(arch, cell):
    """The whole cell at its published size, SMOKE vocabularies: every array
    equal to JAX's from the same generator (keys drawn in sorted order)."""
    spec, jspec = get_arch(arch), j_get_arch(arch)
    got = api.make_inputs(np.random.default_rng(7), spec.smoke_config,
                          spec.cell(cell), device="cpu")["batch"]
    exp = j_api.make_inputs(np.random.default_rng(7), jspec.smoke_config,
                            jspec.cell(cell))["batch"]
    assert sorted(got) == sorted(exp)
    for k, v in exp.items():
        v = np.asarray(v)
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("arch", list(j_list_archs()))
def test_model_flops_and_bytes_equal_jax_at_full_config(arch):
    spec, jspec = get_arch(arch), j_get_arch(arch)
    for cell, jcell in zip(spec.shapes, jspec.shapes):
        assert api.model_flops(spec.config, cell) == j_api.model_flops(
            jspec.config, jcell), cell.name
        assert api.model_bytes(spec.config, cell) == j_api.model_bytes(
            jspec.config, jcell), cell.name


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layer_norm_and_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 7, 24)) * 3 + 1).astype(np.float32)
    s, b = (rng.standard_normal(24).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        layers.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                          torch.from_numpy(b)).numpy(),
        np.asarray(jlayers.layer_norm(x, s, b)), rtol=1e-6, atol=1e-6)
    jp = jlayers.init_mlp(jax.random.PRNGKey(1), (24, 16, 8), jnp.float32)
    jp = {k: v + 0.1 if k.startswith("b") else v for k, v in jp.items()}
    tp = layers.init_mlp(None, (24, 16, 8), torch.float32, "cpu")
    tp.load_state_dict({k: torch.tensor(np.asarray(v))
                        for k, v in jp.items()})
    for act, jact in ((F.relu, jax.nn.relu),
                      (F.leaky_relu, jax.nn.leaky_relu)):
        for final in (False, True):
            got = layers.mlp(tp, torch.from_numpy(x), 2, act=act,
                             final_act=final).numpy()
            exp = np.asarray(jlayers.mlp(jp, x, 2, act=jact,
                                         final_act=final))
            np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)
            assert (got >= 0).all() == (final and act is F.relu)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the blocks use
    ``F.gelu(approximate="tanh")``, not torch's default erf form."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    exp = np.asarray(jax.nn.gelu(x))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    erf = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, exp, rtol=1e-6, atol=1e-6)
    assert np.abs(erf - exp).max() > 1e-4


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(mode, weighted):
    """Padding (id 0) masked, an all-padding bag (mean 0), weights, and
    out-of-range ids: V and past it give a NaN row, as ``jnp.take``'s fill
    mode does; -1 and -V count from the end; -V-1 gives NaN."""
    rng = np.random.default_rng(1)
    V, D = 50, 6
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (6, 5)).astype(np.int32)
    idx[1] = 0
    idx[2, :3] = [V, -1, -V]
    idx[3, 1] = V + 7
    idx[4, 4] = -V - 1
    w = rng.random((6, 5)).astype(np.float32) if weighted else None
    got = recsys.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(idx), mode=mode,
        weights=None if w is None else torch.from_numpy(w)).numpy()
    exp = np.asarray(jrecsys.embedding_bag(table, idx, mode=mode, weights=w))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    assert np.isnan(exp[[2, 3, 4]]).all()
    assert not np.isnan(exp[[0, 1, 5]]).any()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1], 0.0)


def test_take_and_clamped_follow_jax_gather_rules():
    t = np.arange(12, dtype=np.float32).reshape(4, 3)
    i = np.array([0, 3, 4, -1, -4, -5, 100], np.int32)
    got = layers.take(torch.from_numpy(t), torch.from_numpy(i)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.take(t, i, axis=0)))
    got = torch.from_numpy(t)[layers.clamped(torch.from_numpy(i), 4)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(t)[i]))
    lin = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(
        layers.take(torch.from_numpy(lin), torch.from_numpy(i)).numpy(),
        np.asarray(jnp.take(lin, i, axis=0)))


# ---------------------------------------------------------------------------
# the serving steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["serve", "retrieval"])
@pytest.mark.parametrize("arch", RECSYS)
def test_serve_fn_matches_jax(arch, kind):
    cfg = get_arch(arch).smoke_config
    cell = SERVE if kind == "serve" else RETRIEVAL
    got, exp = _serve(cfg, cell), _jserve(cfg, cell)
    if isinstance(exp, tuple):
        _assert_topk(got, exp)
        return
    exp = np.asarray(exp)
    assert got.shape == exp.shape and np.isfinite(exp).all()
    atol = 1e-5 * (np.abs(exp).max() if arch == "xdeepfm" else 1.0)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=atol)


def test_bert4rec_hierarchical_topk_matches_jax_past_100k_items():
    """Past 100,000 items the serve kind takes the chunked top-k: 150,002
    ids padded to 150,016 (16 chunks of 9,376, the pad at -1e30)."""
    cfg = WIDE_BERT4REC
    cell = api.ShapeCell("s", "serve", {"batch": 6})
    got, exp = _serve(cfg, cell), _jserve(cfg, cell)
    assert got[0].shape == (6, 100)
    _assert_topk(got, exp)


def test_topk_ties_go_to_the_lowest_index_as_lax_top_k():
    """Duplicate candidates (two-tower) and duplicate item rows (BERT4Rec)
    tie exactly; the ids come out in ``lax.top_k``'s order."""
    cfg = get_arch("two-tower-retrieval").smoke_config
    batch = _np_batch(cfg, RETRIEVAL)
    batch["cand_ids"] = np.repeat(batch["cand_ids"][:60], 5)
    jp, _, model, jcfg, _ = _models(cfg)
    got = recsys.retrieval_scores(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    exp = jrecsys.retrieval_scores(jp, batch, jcfg)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(exp[1]))
    assert (np.diff(np.asarray(exp[1])[0][::5]) != 0).all()

    cfg = WIDE_BERT4REC
    jp, tree, _, jcfg, _ = _models(cfg)
    emb = tree["item_emb"].copy()
    emb[1::2] = emb[0::2]          # every odd id ties with the even before it
    tree = dict(tree, item_emb=emb)
    model = model_from_jax(tree, cfg, device="cpu")
    batch = _np_batch(cfg, api.ShapeCell("s", "serve", {"batch": 3}))
    got = recsys.bert4rec_topk_serve(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    exp = jrecsys.bert4rec_topk_serve(
        jax.tree.map(jnp.asarray, tree), batch, jcfg)
    gi, ei = got[1].numpy(), np.asarray(exp[1])
    assert (ei[:, 0::2] % 2 == 0).all()
    assert (ei[:, 1::2] == ei[:, 0::2] + 1).all()
    np.testing.assert_array_equal(gi, ei)


def test_out_of_range_ids_give_jax_nan_rows():
    """A BST target past the catalogue and an xDeepFM field past the table
    give NaN logits on those rows only, as in JAX."""
    for arch, key, bad in (("bst", "target", 10_000), ("xdeepfm", "fields",
                                                       -9_999)):
        cfg = get_arch(arch).smoke_config
        batch = _np_batch(cfg, SERVE)
        batch[key] = batch[key].copy()
        batch[key][[2, 5]] = bad
        jp, _, model, jcfg, _ = _models(cfg)
        got = api.serve_fn(cfg, SERVE)(
            model, {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
        exp = np.asarray(j_api.serve_fn(jcfg, SERVE)(jp, batch))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
        assert np.isnan(exp[[2, 5]]).all() and np.isnan(exp).sum() == 2


def test_xdeepfm_cin_in_row_chunks_equals_one_block(monkeypatch):
    cfg = get_arch("xdeepfm").smoke_config
    one = _serve(cfg, SERVE)
    monkeypatch.setattr(recsys, "CIN_CHUNK_BYTES", 5 * 8 * 8 * 6 * 4)
    chunked = _serve(cfg, SERVE)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-6 * float(one.abs().max()))


def test_serving_api_boundaries():
    """A GNN has no serving step (``TypeError``, as in JAX); the training
    half answers for it as JAX's does (replicated, batch over 'dp', the
    masked node loss), and an unknown config is a ``TypeError`` there
    too."""
    gcfg = get_arch("gat-cora").smoke_config
    jgcfg = j_get_arch("gat-cora").smoke_config
    with pytest.raises(TypeError):
        api.serve_fn(gcfg, SERVE)
    with pytest.raises(TypeError):
        j_api.serve_fn(jgcfg, SERVE)
    with pytest.raises(TypeError):
        api.init_params(object(), generator=torch.Generator(), device="cpu")
    assert api.sharding_rules(gcfg) == j_api.sharding_rules(jgcfg) == []
    assert api.serve_rules(gcfg) == j_api.serve_rules(jgcfg) == []
    assert api.batch_axis_for(gcfg, SERVE) == \
        j_api.batch_axis_for(jgcfg, SERVE) == "dp"
    assert callable(api.loss_fn(gcfg))
    for fn in (api.loss_fn, j_api.loss_fn):
        with pytest.raises(TypeError):
            fn(object())

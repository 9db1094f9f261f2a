"""The training half of the PyTorch port's model API (CPU) against the JAX
package: each architecture's loss, metrics and gradients, remat, the
abstract parameter tree and the sharding tables, and a 10-step trajectory
of the danube SMOKE model.

Each of the ten architectures runs at SMOKE size on
``tests/test_arch_smoke.py``'s train cells, on ``make_inputs``' batch
(equal array for array in both packages) and JAX's ``init_params`` weights
carried across by ``models.convert``; JAX's ``value_and_grad`` runs under
``jax.jit``, for the LMs also with ``use_pallas_attention=True`` (the
Pallas forward in interpret mode, its ``custom_vjp`` backward).
Tolerances, and why:

  * losses and metrics within rtol 1e-5, and every gradient leaf within
    2e-5 of the leaf's largest magnitude: both sides compute in f32 and
    differ only in summation order (XLA's CPU dots and reductions against
    torch's); measured at most 2.2e-6 on every architecture, so the bar
    leaves a decade;
  * a GAT's segment max: where two edges tie for a segment's max (an edge
    drawn twice), torch's ``scatter_reduce("amax")`` shares the max's
    gradient between them and JAX's scatter-max gradient does not. That
    gradient is zero up to rounding (the softmax does not depend on its
    shift), so the same bar holds; the test counts such segments;
  * remat ``"none"``, ``"full"`` and ``"dots"``: gradients bit for bit (the
    same ops recomputed on the CPU);
  * the 10-step trajectory: losses, ``grad_norm`` and ``lr`` within rtol
    1e-4; every leaf of the parameters and the state (master copies,
    ``m``, ``v``) within 1e-3 relative RMS (measured at most 8.4e-5), and
    each parameter element within twice the sum of the learning rates:
    AdamW moves an element by about ``lr`` a step whatever its gradient's
    size, so where a gradient is near zero its 1e-6 difference can flip
    the step's sign, and later gradients follow the moved parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as j_get_arch, list_archs as j_list_archs
from repro.configs.gat_cora import adapt_config as j_adapt_gat
from repro.data.lm_data import LMDataConfig as JLMDataConfig
from repro.data.lm_data import SyntheticTokenStream as JStream
from repro.models import api as j_api
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import get_arch
from repro_torch.configs.gat_cora import adapt_config
from repro_torch.data.lm_data import LMDataConfig, SyntheticTokenStream
from repro_torch.models import api, convert, gnn
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step, value_and_grad)

GRAD_TOL = 2e-5
CELLS = {   # tests/test_arch_smoke.py's train cells
    "lm": ("train_smoke", "train", {"batch": 2, "seq": 32}),
    "gnn": ("graph_smoke", "train", {"n_nodes": 64, "n_edges": 256,
                                     "d_feat": 32, "n_classes": 5}),
    "recsys": ("train_smoke", "train", {"batch": 16}),
}


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the SMOKE models are small, and torch's pool
    beside XLA's oversubscribes the cores (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def _leaf_close(got, exp, tol, what):
    got, exp = _f32(got), _f32(exp)
    assert got.shape == exp.shape, what
    np.testing.assert_allclose(got, exp, rtol=tol,
                               atol=tol * float(np.abs(exp).max(initial=0)),
                               err_msg=what)


def _smoke(arch):
    spec, jspec = get_arch(arch), j_get_arch(arch)
    cell = api.ShapeCell(*CELLS[spec.family])
    jcell = j_api.ShapeCell(*CELLS[spec.family])
    cfg, jcfg = spec.smoke_config, jspec.smoke_config
    if spec.family == "gnn":
        cfg, jcfg = adapt_config(cfg, cell), j_adapt_gat(jcfg, jcell)
    return spec, cfg, jcfg, cell, jcell


def _model(spec, cfg, jparams):
    tree = jax.tree.map(np.asarray, jparams)
    if spec.family == "lm":
        return convert.params_from_jax(tree, cfg, device="cpu")
    return convert.model_from_jax(tree, cfg, device="cpu")


class _TiedMaxima:
    """Wraps ``gnn.segment_max`` to count the (segment, head) maxima over
    valid edges (above the -1e30 of masked ones) that two or more edges
    attain."""

    def __init__(self, monkeypatch):
        self.n, real = 0, gnn.segment_max

        def counted(data, seg, n):
            out = real(data, seg, n)
            at = gnn._segments(seg, n).clamp_max(n - 1)
            hits = (data == out[at]) & (data > -1e29)
            per = torch.zeros_like(out).index_add_(0, at, hits.float())
            self.n += int((per > 1).sum())
            return out
        monkeypatch.setattr(gnn, "segment_max", counted)


@pytest.mark.parametrize("arch", list(j_list_archs()))
def test_loss_and_gradients_match_jax(arch, monkeypatch):
    spec, cfg, jcfg, cell, jcell = _smoke(arch)
    jparams = j_api.init_params(jax.random.PRNGKey(0), jcfg)
    jbatch = j_api.make_inputs(np.random.default_rng(0), jcfg, jcell)["batch"]
    batch = api.make_inputs(np.random.default_rng(0), cfg, cell,
                            device="cpu")["batch"]
    assert sorted(batch) == sorted(jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(),
                                      np.asarray(jbatch[k]))
    model = _model(spec, cfg, jparams)
    ties = _TiedMaxima(monkeypatch)
    (loss, metrics), grads = value_and_grad(api.loss_fn(cfg), model, batch)
    grads = convert.jax_leaves(model, grads)
    jcfgs = [jcfg] + ([dataclasses.replace(jcfg, use_pallas_attention=True)]
                      if spec.family == "lm" else [])
    for c in jcfgs:
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            j_api.loss_fn(c), has_aux=True))(jparams, jbatch)
        _leaf_close(loss, jloss, 1e-5, "loss")
        assert sorted(metrics) == sorted(jmetrics)
        for k in metrics:
            _leaf_close(metrics[k], jmetrics[k], 1e-5, k)
        paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
        assert len(paths) == len(grads)
        for g, (path, jg) in zip(grads, paths):
            assert g.dtype == getattr(torch, str(jg.dtype))
            _leaf_close(g, jg, GRAD_TOL, jax.tree_util.keystr(path))
    if spec.family == "gnn":   # the bar holds with tied maxima present
        assert ties.n > 0, "no segment's max is tied on this cell"
        print(f"gat SMOKE: {ties.n} (segment, head) maxima tied")


def test_bert4rec_switches_to_sampled_softmax_above_100k_items():
    """The full config (1M items) trains on 8,192 shared negatives, as
    JAX's does; the sampled loss on a small model equals JAX's."""
    full = get_arch("bert4rec").config
    cell = get_arch("bert4rec").cell("train_batch")
    specs = api.input_specs(full, cell)["batch"]
    assert specs["neg_ids"].shape == (8192,) and "loss_mask" not in specs
    small = dataclasses.replace(get_arch("bert4rec").smoke_config,
                                n_items=100_001, seq_len=20)
    jsmall = dataclasses.replace(j_get_arch("bert4rec").smoke_config,
                                 n_items=100_001, seq_len=20)
    c = api.ShapeCell("t", "train", {"batch": 4})
    jparams = j_api.init_params(jax.random.PRNGKey(2), jsmall)
    model = convert.model_from_jax(jax.tree.map(np.asarray, jparams), small,
                                   device="cpu")
    jb = j_api.make_inputs(np.random.default_rng(2), jsmall,
                           j_api.ShapeCell("t", "train", {"batch": 4}))
    b = api.make_inputs(np.random.default_rng(2), small, c, device="cpu")
    (loss, _), grads = value_and_grad(api.loss_fn(small), model, b["batch"])
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        j_api.loss_fn(jsmall), has_aux=True))(jparams, jb["batch"])
    _leaf_close(loss, jloss, 1e-5, "loss")
    for g, jg in zip(convert.jax_leaves(model, grads),
                     jax.tree.leaves(jgrads)):
        _leaf_close(g, jg, GRAD_TOL, "grad")


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-moe-a2.7b"])
def test_remat_policies_give_equal_gradients(arch):
    """"none", "full" and "dots" give the same gradients bit for bit;
    "full" recomputes the blocks' matrix products in the backward pass,
    "dots" keeps them (the parameter products: ``mm``) and recomputes the
    rest (the attention's batched products: ``bmm``)."""
    cfg = get_arch(arch).smoke_config
    model = tr.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32))
    out, mm, bmm = {}, torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        with _CountOps() as ops:
            out[remat] = value_and_grad(api.loss_fn(c), model,
                                        {"tokens": tokens})
        out[remat] += (ops.n.get(mm, 0), ops.n.get(bmm, 0))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0][0], out["none"][0][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b), remat
    assert out["full"][2] > out["none"][2] == out["dots"][2]
    assert out["full"][3] == out["dots"][3] > out["none"][3]
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(api.loss_fn(dataclasses.replace(cfg, remat="some")),
                       model, {"tokens": tokens})


# ---------------------------------------------------------------------------
# the abstract tree and the sharding tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(j_list_archs()))
def test_abstract_params_and_rules_match_jax(arch):
    spec, jspec = get_arch(arch), j_get_arch(arch)
    got = api.abstract_params(spec.config)
    exp = j_api.abstract_params(jspec.config)
    flat = jax.tree_util.tree_flatten_with_path(exp)[0]
    mine = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, api.TensorSpec))[0]
    assert [jax.tree_util.keystr(p) for p, _ in mine] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    for (_, g), (_, e) in zip(mine, flat):
        assert g.shape == e.shape and str(g.dtype).split(".")[1] == \
            str(e.dtype)
    assert api.sharding_rules(spec.config) == j_api.sharding_rules(
        jspec.config)
    assert api.serve_rules(spec.config) == j_api.serve_rules(jspec.config)
    for cell, jcell in zip(spec.shapes, jspec.shapes):
        assert api.batch_axis_for(spec.config, cell) == \
            j_api.batch_axis_for(jspec.config, jcell)


# ---------------------------------------------------------------------------
# a trajectory
# ---------------------------------------------------------------------------

def test_danube_smoke_trajectory_matches_jax():
    """10 steps of the danube SMOKE model from JAX's weights on the token
    stream's batches, AdamW with master weights: every step's loss and the
    final parameters against JAX's jitted train step."""
    spec, cfg, jcfg, _, _ = _smoke("h2o-danube-1.8b")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    tcfg = TrainConfig(opt=opt.AdamWConfig(**kw))
    jtcfg = jtl.TrainConfig(opt=jopt.AdamWConfig(**kw))
    jparams = j_api.init_params(jax.random.PRNGKey(0), jcfg)
    model = _model(spec, cfg, jparams)
    state, jstate = init_train_state(model, tcfg), \
        jtl.init_train_state(jparams, jtcfg)
    step = make_train_step(api.loss_fn(cfg), tcfg)
    jstep = jax.jit(jtl.make_train_step(j_api.loss_fn(jcfg), jtcfg))
    data = SyntheticTokenStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=32, batch_size=4))
    jdata = JStream(JLMDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  batch_size=4))
    for s in range(10):
        model, state, m = step(model, state,
                               {"tokens": torch.from_numpy(data.batch(s))})
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {"tokens": jnp.asarray(jdata.batch(s))})
        for k in ("loss", "nll", "grad_norm", "lr"):
            _leaf_close(m[k], jm[k], 1e-4, f"step {s} {k}")
    step_bound = 2 * kw["lr"] * 10
    for g, (path, e) in zip(convert.train_leaves(model, state),
                            jax.tree_util.tree_flatten_with_path(
                                (jparams, jstate))[0]):
        what = jax.tree_util.keystr(path)
        g, e = _f32(g), _f32(e)
        rms = np.sqrt(np.sum((g - e) ** 2) / max(np.sum(e ** 2), 1e-30))
        assert rms <= 1e-3, (what, rms)
        if "'opt'" not in what or "'master'" in what:
            assert np.abs(g - e).max() <= step_bound, what
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 10

"""The PyTorch port's training slice (CPU) against the JAX package: AdamW
and its schedules, int8 gradient compression with error feedback, the
train step (microbatches, compression), the token stream, bf16
checkpoints, the optimizer state carried both ways, and the launcher's
preempt-and-resume and its checkpoints crossing between the two trainers.
Ports ``tests/test_training_ft.py``'s optimizer, compression and train-loop
cases.

Inputs come from numpy seeds and are handed to both packages; JAX's train
steps run under ``jax.jit``, as its trainer runs them. Tolerances, and why:

  * f32 optimizer values (``lr``, ``grad_norm``, parameters, ``m``,
    ``v``, ``master``) within 2e-6 (~16 ulps) of each leaf's largest
    magnitude: XLA folds a division by a constant into a multiplication by
    its reciprocal and fuses multiply-adds, so single ops differ by an ulp
    of their operands, and an AdamW update chains about ten of them; bf16
    parameters within one bf16 ulp (rtol 2^-7) for the same reason;
  * the int8 payloads, scales and 50 error-feedback steps bit for bit (the
    same f32 ops, round half to even on both sides);
  * the token stream bit for bit (the same numpy code);
  * train steps of a model (grad_accum, compression, the 40-step smoke):
    JAX's own bars from ``tests/test_training_ft.py``, or rtol 1e-4 where a
    model's f32 gradients enter (sums in another order, ~1e-6 relative an
    op over two layers);
  * the launcher's preempted-and-resumed run against the run without the
    kill: bit for bit (the same process, the same ops, a checkpoint that
    stores the exact bits).
"""
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proptest import property_test
from repro.configs import get_arch as j_get_arch
from repro.data.lm_data import (LMDataConfig as JLMDataConfig,
                                SyntheticTokenStream as JStream)
from repro.distributed.fault_tolerance import \
    CheckpointManager as JCheckpointManager
from repro.launch import train as j_train
from repro.models import api as j_api
from repro.training import grad_compression as jgc
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs import get_arch
from repro_torch.data.lm_data import LMDataConfig, SyntheticTokenStream
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.launch import train as t_train
from repro_torch.models import api, convert
from repro_torch.training import grad_compression as gc
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step, trainable)

RTOL32 = 2e-6
BF16_RTOL = 2 ** -7


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


def _np(x):
    x = x.detach().float() if isinstance(x, torch.Tensor) else \
        jnp.asarray(x, jnp.float32)
    return np.asarray(x)


def _close(got, exp, rtol=RTOL32, atol=None):
    """Within ``rtol``, and ``atol`` (default ``rtol`` times the largest
    magnitude of ``exp``)."""
    exp = _np(exp)
    if atol is None:
        atol = rtol * float(np.max(np.abs(exp), initial=0.0))
    np.testing.assert_allclose(_np(got), exp, rtol=rtol, atol=atol)


def _torch(a, dtype):
    """A JAX or numpy array as a torch tensor of ``dtype``, exactly."""
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        getattr(torch, dtype))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    jc, tc = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    steps = np.arange(130, dtype=np.int32)
    exp = jax.jit(jax.vmap(lambda s: jopt.lr_at(jc, s)))(steps)
    got = torch.stack([opt.lr_at(tc, torch.tensor(s)) for s in steps])
    assert got.dtype == torch.float32
    _close(got, exp)
    assert float(opt.lr_at(tc, 0)) == 0.0


SHAPES = {"a": (4, 8), "b": (16,), "w": (3, 5, 7)}


@pytest.mark.parametrize("master,dtype", [(True, "float32"),
                                          (False, "float32"),
                                          (True, "bfloat16"),
                                          (False, "bfloat16")])
def test_apply_updates_matches_jax(master, dtype):
    """Six steps of random gradients (one large enough to clip): the
    parameters, m, v, master, grad_norm and lr."""
    rng = np.random.default_rng(0)
    jp = {k: jnp.asarray(rng.standard_normal(s), dtype)
          for k, s in SHAPES.items()}
    tp = {k: _torch(v, dtype) for k, v in jp.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, master_weights=master)
    jc, tc = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    js, ts = jopt.init_state(jp, jc), opt.init_state(tp, tc)
    assert ts["step"].dtype == torch.int32 and ("master" in ts) == master
    upd = jax.jit(lambda p, g, s: jopt.apply_updates(p, g, s, jc))
    for step in range(6):
        scale = 3.0 if step == 2 else 0.1
        jg = {k: jnp.asarray(rng.standard_normal(s) * scale, dtype)
              for k, s in SHAPES.items()}
        jp, js, jm = upd(jp, jg, js)
        tp, ts, tm = opt.apply_updates(
            tp, [_torch(jg[k], dtype) for k in sorted(jg)], ts, tc)
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
    assert int(ts["step"]) == int(js["step"]) == 6
    for k in sorted(SHAPES):
        assert tp[k].dtype == getattr(torch, dtype)
        _close(tp[k], jp[k], rtol=RTOL32 if dtype == "float32" else
               BF16_RTOL)
    for name in ["m", "v"] + (["master"] if master else []):
        for got, exp in zip(ts[name], jax.tree.leaves(js[name])):
            _close(got, exp)


def test_lr_schedule_warmup_cosine():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(opt.lr_at(cfg, 0)) == 0.0
    assert abs(float(opt.lr_at(cfg, 10)) - 1.0) < 1e-6
    assert float(opt.lr_at(cfg, 5)) == pytest.approx(0.5)
    assert float(opt.lr_at(cfg, 100)) == pytest.approx(cfg.min_lr_frac,
                                                       rel=1e-3)


def test_grad_clipping():
    params = {"w": torch.ones(4)}
    cfg = opt.AdamWConfig(clip_norm=1.0, master_weights=False)
    st = opt.init_state(params, cfg)
    _, _, m = opt.apply_updates(params, [torch.ones(4) * 100.0], st, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def _quad_loss(params, batch):
    r = params["w"] - batch["target"]
    return torch.sum(r * r), {}


def test_adamw_descends_quadratic():
    params = {"w": torch.ones(16) * 5.0}
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=0.1, warmup_steps=0,
                                           weight_decay=0.0,
                                           schedule="constant",
                                           master_weights=False))
    state = init_train_state(params, tcfg)
    step = make_train_step(_quad_loss, tcfg)
    batch = {"target": torch.zeros(16)}
    losses = []
    for _ in range(60):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < 1e-2 * losses[0]
    assert not params["w"].requires_grad   # switched off after each step


def _mse(params, batch, mm):
    pred = mm(batch["x"], params["w"])
    return ((pred - batch["y"]) ** 2).mean(), {}


def test_grad_accum_matches_full_batch_and_jax():
    """accum over 4 microbatches == one step on the full batch (JAX's bar,
    rtol 2e-5, atol 1e-6), and each equals JAX's step."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 1)).astype(np.float32)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = rng.standard_normal((32, 1)).astype(np.float32)
    out = {}
    for accum in (1, 4):
        kw = dict(lr=0.01, warmup_steps=0, schedule="constant",
                  master_weights=False)
        tcfg = TrainConfig(opt=opt.AdamWConfig(**kw), grad_accum=accum)
        jcfg = jtl.TrainConfig(opt=jopt.AdamWConfig(**kw), grad_accum=accum)
        params = {"w": torch.from_numpy(w.copy())}
        params, _, m = make_train_step(
            lambda p, b: _mse(p, b, torch.matmul), tcfg)(
            params, init_train_state(params, tcfg),
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        jparams = {"w": jnp.asarray(w)}
        jp, _, jm = jax.jit(jtl.make_train_step(
            lambda p, b: _mse(p, b, jnp.matmul), jcfg))(
            jparams, jtl.init_train_state(jparams, jcfg),
            {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        _close(params["w"], jp["w"], rtol=1e-5, atol=1e-7)
        _close(m["loss"], jm["loss"], rtol=1e-5)
        out[accum] = params["w"]
    _close(out[4], out[1], rtol=2e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_match_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    for scale in (1e-4, 1.0, 37.0):
        a = rng.standard_normal(1000) * scale
        a[:4] = [0.5, -0.5, 1.5, 2.5]   # exact halves once scaled by 1
        jq, js = jgc.quantize(jnp.asarray(a, dtype))
        tq, ts = gc.quantize(_torch(jnp.asarray(a, dtype), dtype))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts) == np.float32(js)
        np.testing.assert_array_equal(
            gc.dequantize(tq, ts).numpy(), np.asarray(jgc.dequantize(jq, js)))
    zq, zs = gc.quantize(torch.zeros(8))
    assert float(zs) == float(np.float32(1e-12)) and not zq.any()


@property_test(n_cases=5)
def test_quantize_roundtrip_bounds(rng):
    g = torch.from_numpy((rng.standard_normal(256) * rng.random() * 10)
                         .astype(np.float32))
    q, s = gc.quantize(g)
    deq = gc.dequantize(q, s)
    assert float(torch.max(torch.abs(deq - g))) <= float(s) * 0.5 + 1e-6


def test_error_feedback_matches_jax_for_50_steps():
    """50 steps of the same gradients: outputs and feedback bit for bit,
    and the mean output converges to the true gradient (JAX's bar)."""
    rng = np.random.default_rng(1)
    g_true = (rng.standard_normal(64) * 0.01).astype(np.float32)
    g2 = rng.standard_normal((3, 5)).astype(np.float32)
    jef = jgc.init_error_feedback({"g": jnp.asarray(g_true),
                                   "h": jnp.asarray(g2)})
    tef = gc.init_error_feedback({"g": torch.from_numpy(g_true),
                                  "h": torch.from_numpy(g2)})
    total = torch.zeros(64)
    for _ in range(50):
        jout, jef = jgc.compress_with_error_feedback(
            {"g": jnp.asarray(g_true), "h": jnp.asarray(g2)}, jef)
        tout, tef = gc.compress_with_error_feedback(
            [torch.from_numpy(g_true), torch.from_numpy(g2)], tef)
        for got, exp in zip(tout + tef, jax.tree.leaves(jout)
                            + jax.tree.leaves(jef)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
        total += tout[0]
    np.testing.assert_allclose(total.numpy() / 50, g_true, atol=1e-4)


def test_compressed_psum_waits_for_the_sharded_trainer():
    with pytest.raises(NotImplementedError, match="14.4b"):
        gc.compressed_psum(torch.ones(4), "dp")


def test_compressed_train_step_keeps_error_feedback_as_jax():
    """Three steps with ``compress_grads``: parameters and ``ef`` against
    JAX's."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((8, 3)).astype(np.float32)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    y = rng.standard_normal((16, 3)).astype(np.float32)
    kw = dict(lr=0.05, warmup_steps=0, schedule="constant")
    tcfg = TrainConfig(opt=opt.AdamWConfig(**kw), compress_grads=True)
    jcfg = jtl.TrainConfig(opt=jopt.AdamWConfig(**kw), compress_grads=True)
    params, jparams = {"w": torch.from_numpy(w.copy())}, {"w": jnp.asarray(w)}
    state = init_train_state(params, tcfg)
    jstate = jtl.init_train_state(jparams, jcfg)
    step = make_train_step(lambda p, b: _mse(p, b, torch.matmul), tcfg)
    jstep = jax.jit(jtl.make_train_step(lambda p, b: _mse(p, b, jnp.matmul),
                                        jcfg))
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    for _ in range(3):
        params, state, _ = step(params, state, batch)
        jparams, jstate, _ = jstep(jparams, jstate, jbatch)
    _close(params["w"], jparams["w"], rtol=1e-5, atol=1e-6)
    _close(state["ef"][0], jstate["ef"]["w"], rtol=1e-4, atol=1e-6)
    _close(state["opt"]["master"][0], jstate["opt"]["master"]["w"],
           rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the train loop on a model
# ---------------------------------------------------------------------------

def test_trainable_restores_the_flags():
    model = api.init_params(get_arch("bst").smoke_config,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    ps = opt.leaves(model)
    assert not any(p.requires_grad for p in ps)
    with trainable(ps):
        assert all(p.requires_grad for p in ps)
    assert not any(p.requires_grad for p in ps)


def test_train_loop_smoke_lm_loss_decreases():
    """danube SMOKE, 40 steps of 8 x 32 tokens: the loss drops by more
    than 0.5 (JAX's test)."""
    cfg = get_arch("h2o-danube-1.8b").smoke_config
    data = SyntheticTokenStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=32, batch_size=8))
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=3e-3, warmup_steps=5,
                                           total_steps=40,
                                           master_weights=False))
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    state = init_train_state(params, tcfg)
    step = make_train_step(api.loss_fn(cfg), tcfg)
    losses = []
    for s in range(40):
        params, state, m = step(params, state,
                                {"tokens": torch.from_numpy(data.batch(s))})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(vocab_size=97, seq_len=17,
                                             batch_size=3, n_states=5,
                                             seed=7)], ids=["default", "odd"])
def test_token_stream_matches_jax(kw):
    got, exp = SyntheticTokenStream(LMDataConfig(**kw)), \
        JStream(JLMDataConfig(**kw))
    for step in (0, 1, 41):
        a, b = got.batch(step), exp.batch(step)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    it = got.batches(5)
    assert next(it)[0] == 5 and next(it)[0] == 6


# ---------------------------------------------------------------------------
# checkpoints: bf16 leaves, the optimizer state, the launcher
# ---------------------------------------------------------------------------

def _bf16_leaves(rng, scale=1.0):
    a = jnp.asarray(rng.standard_normal((6, 4)) * scale, jnp.bfloat16)
    return [a, jnp.asarray(rng.standard_normal(5), jnp.float32),
            jnp.asarray(3, jnp.int32)]


def test_bf16_checkpoints_cross_both_ways_with_deltas(tmp_path):
    """A JAX-written bf16 leaf restores in the port bit for bit and back,
    through a delta chain (``full_interval=3``) on both sides."""
    rng = np.random.default_rng(0)
    saves = [_bf16_leaves(rng, s) for s in (1.0, 1.0, 2.0)]
    saves[1][0] = saves[0][0].at[2].set(7.0)    # one row changed: a delta
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck = JCheckpointManager(jdir, keep_n=5, full_interval=3)
    tck = CheckpointManager(tdir, keep_n=5, full_interval=3)
    for step, leaves in enumerate(saves, 1):
        jck.save(step, leaves)
        tck.save(step, [np.asarray(x) for x in leaves])
    assert [tck.manifest(s)["kind"] for s in (1, 2, 3)] == \
        [jck.manifest(s)["kind"] for s in (1, 2, 3)] == \
        ["full", "delta", "delta"]
    for s in (1, 2, 3):
        assert tck.manifest(s)["raw_dtypes"] == jck.manifest(s)[
            "raw_dtypes"] == {"leaf_0": "bfloat16"}
    template = [torch.zeros(1, dtype=torch.bfloat16), torch.zeros(1),
                torch.zeros((), dtype=torch.int32)]
    for d in (jdir, tdir):
        for step, leaves in enumerate(saves, 1):
            got, at = CheckpointManager(d).restore(template, step)
            assert at == step and got[0].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[0].view(torch.int16).numpy(),
                np.asarray(leaves[0]).view(np.int16))
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(leaves[1]))
            back, _ = JCheckpointManager(d).restore(
                [jnp.zeros((6, 4), jnp.bfloat16), jnp.zeros(5),
                 jnp.zeros((), jnp.int32)], step)
            np.testing.assert_array_equal(np.asarray(back[0]).view(np.int16),
                                          np.asarray(leaves[0]).view(
                                              np.int16))


def test_train_state_carries_both_ways_in_jax_leaf_order():
    """A JAX (params, train_state) of a bf16 danube SMOKE with master
    weights and compression, every leaf drawn at random (the step at 2),
    loads into the port's module and state and comes back leaf for leaf,
    bit for bit."""
    import dataclasses
    jcfg = dataclasses.replace(j_get_arch("h2o-danube-1.8b").smoke_config,
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("h2o-danube-1.8b").smoke_config,
                              dtype="bfloat16")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jtcfg = jtl.TrainConfig(opt=jopt.AdamWConfig(**kw), compress_grads=True)

    def init():
        params = j_api.init_params(jax.random.PRNGKey(0), jcfg)
        return params, jtl.init_train_state(params, jtcfg)
    rng = np.random.default_rng(4)
    jparams, jstate = jax.tree.map(
        lambda x: jnp.asarray(2 if x.ndim == 0 else rng.standard_normal(
            x.shape), x.dtype), jax.eval_shape(init))
    exp = jax.tree.leaves((jparams, jstate))
    tcfg = TrainConfig(opt=opt.AdamWConfig(**kw), compress_grads=True)
    params = api.init_params(cfg, generator=torch.Generator().manual_seed(1),
                             device="cpu")
    state = init_train_state(params, tcfg)
    convert.load_train_leaves(params, state, [np.asarray(x) for x in exp])
    assert int(state["opt"]["step"]) == 2
    got = convert.train_leaves(params, state)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert tuple(g.shape) == e.shape
        assert str(g.dtype).split(".")[1] == str(e.dtype)
        if e.dtype == jnp.bfloat16:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          np.asarray(e).view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    with pytest.raises(ValueError, match="leaves"):
        convert.load_train_leaves(params, state, got[:-1])


def _run_port(argv):
    return t_train.run(argv + ["--device", "cpu"], log=lambda s: None)


def _leaves_np(res):
    return [t.float().numpy() for t in convert.train_leaves(res["params"],
                                                            res["state"])]


@pytest.mark.parametrize("flags", [[], ["--grad-accum", "2",
                                        "--compress-grads"]],
                         ids=["plain", "accum_compress"])
def test_launcher_preempt_and_resume_equals_the_uninterrupted_run(tmp_path,
                                                                  flags):
    base = ["--steps", "12", "--ckpt-every", "4", "--batch", "2", "--seq",
            "16"] + flags
    whole = _run_port(base + ["--ckpt-dir", str(tmp_path / "whole")])
    cut = _run_port(base + ["--ckpt-dir", str(tmp_path / "cut"),
                            "--simulate-preemption", "10"])
    assert cut["preempted"] and len(cut["losses"]) == 10
    resumed = _run_port(base + ["--ckpt-dir", str(tmp_path / "cut")])
    assert resumed["start"] == 9      # the checkpoint at step 8
    assert cut["losses"][:9] + resumed["losses"] == whole["losses"]
    for a, b in zip(_leaves_np(resumed), _leaves_np(whole)):
        np.testing.assert_array_equal(a, b)


def _run_jax(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()


def test_checkpoints_cross_between_the_jax_and_port_launchers(
        tmp_path, monkeypatch, capsys):
    """JAX's launcher stops at step 5 with a checkpoint at step 4; the
    port's launcher resumes it to step 8 and JAX's own resumes it to step 8
    too: the port's losses and step-8 checkpoint match JAX's (rtol 1e-4),
    and the port's checkpoint restores in JAX."""
    base = ["--steps", "9", "--ckpt-every", "4", "--batch", "2", "--seq",
            "16", "--lr", "1e-2"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _run_jax(base[:1] + ["5"] + base[2:] + ["--ckpt-dir", str(jdir)],
             monkeypatch)
    shutil.copytree(jdir, tdir)
    capsys.readouterr()
    res = _run_port(base + ["--ckpt-dir", str(tdir)])
    assert res["start"] == 5
    _run_jax(base + ["--ckpt-dir", str(jdir)], monkeypatch)
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 4" in out
    exp_last = float(out.split("step     8 loss ")[1].split()[0])
    assert res["losses"][-1] == pytest.approx(exp_last, rel=1e-4, abs=1e-4)
    jleaves = JCheckpointManager(str(jdir)).load_arrays(8)[0]
    tleaves = CheckpointManager(str(tdir)).load_arrays(8)[0]
    assert len(tleaves) == len(jleaves)
    for k in jleaves:
        np.testing.assert_allclose(tleaves[k], jleaves[k], rtol=1e-4,
                                   atol=1e-5)
    # the port's checkpoint restores in JAX, into the JAX trainer's tree
    cfg = j_get_arch("h2o-danube-1.8b").smoke_config
    jcfg = jtl.TrainConfig(opt=jopt.AdamWConfig(master_weights=False))
    params = j_api.init_params(jax.random.PRNGKey(0), cfg)
    (p, st), step = JCheckpointManager(str(tdir)).restore(
        (params, jtl.init_train_state(params, jcfg)), 8)
    assert step == 8 and int(st["opt"]["step"]) == 9
    np.testing.assert_array_equal(np.asarray(p["embed"]),
                                  res["params"].embed.detach().numpy())

"""The port's tuning layer (CPU) against the JAX package's.

Mirrors ``tests/test_autotune.py`` without its Pallas-only cases: plans
round-trip through JSON and load in either package, the tuner's cache hits
measure nothing, a plan rides snapshot meta both ways (the port's engine
holds none: a JAX snapshot's plan stays in its manifest), the CPU tuner
times twins only and writes their route, and the analytic traffic and
roofline rows equal JAX's.
"""
import pytest

from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SearchAssistanceEngine as JEngine
from repro.core.plan import TunedPlan as JTunedPlan
from repro.core.plan import all_kernel_plan as j_all_kernel_plan
from repro.core.plan import shape_class as j_shape_class
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.stream import SyntheticStream as JStream
from repro.distributed.fault_tolerance import \
    CheckpointManager as JCheckpointManager
from repro.launch import autotune as jautotune
from repro.launch import roofline as jroofline
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.core.plan import (HOT_PATH_OPS, JNP_PLAN, LAYOUT_OPS,
                                   OP_KERNELS, TunedPlan, all_kernel_plan,
                                   shape_class)
from repro_torch.kernels import KERNELS
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.launch import autotune, roofline, serve_assist
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_F32
from repro_torch.serving.serve import SuggestFrontend, pack_suggestions

CFG = dict(query_capacity=1 << 10, cooc_capacity=1 << 12,
           session_capacity=1 << 10, session_window=4, decay_every=4,
           rank_every=6)
STREAM = dict(vocab_size=256, n_users=80, tweets_per_tick=0)


def _cfg(**kw):
    return EngineConfig(**{**CFG, **kw})


def _jcfg(**kw):
    return JEngineConfig(**{**CFG, **kw})


def _batches(ticks, qpt=96):
    stream = JStream(JStreamConfig(**STREAM, queries_per_tick=qpt), seed=5)
    return [stream.gen_tick(t)[0] for t in range(ticks)]


def _run(cfg, batches):
    eng = SearchAssistanceEngine(cfg, device="cpu")
    for ev in batches:
        eng.step(ev)
    return eng


def _bits_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# the plan object and its JSON
# ---------------------------------------------------------------------------

def test_plan_roundtrip_json():
    plan = all_kernel_plan(score_block_rows=32, ingest_chunk=8192,
                           backend="cuda", shape_class="cuda-x-q10-c12-s10")
    assert TunedPlan.from_json(plan.to_json()) == plan
    assert TunedPlan.loads(plan.dumps()) == plan
    assert hash(plan) == hash(TunedPlan.loads(plan.dumps()))
    assert plan.uses_kernel("score_gate")
    assert not JNP_PLAN.uses_kernel("score_gate")
    with pytest.raises(KeyError):
        plan.uses_kernel("flash_attention")


@pytest.mark.parametrize("kind", ["kernel", "jnp", "mixed"])
def test_plan_json_is_jax_field_for_field(kind):
    kw = dict(score_block_rows=8, ingest_chunk=4096, backend="cpu",
              shape_class="cpu-cpu-q10-c12-s10-hash")
    if kind == "kernel":
        j, t = j_all_kernel_plan(**kw), all_kernel_plan(**kw)
    elif kind == "jnp":
        j, t = JTunedPlan(**kw), TunedPlan(**kw)
    else:
        j = JTunedPlan(bucket_topk="kernel", chain_find="kernel", **kw)
        t = TunedPlan(bucket_topk="kernel", chain_find="kernel", **kw)
    assert t.to_json() == j.to_json()
    assert t.dumps() == j.dumps()
    assert JTunedPlan.loads(t.dumps()) == j
    assert TunedPlan.loads(j.dumps()) == t
    assert t.variants() == j.variants()


def test_plan_rejects_unknown_variant():
    with pytest.raises(ValueError, match="score_gate"):
        TunedPlan(score_gate="cuda")
    with pytest.raises(ValueError, match="decay_prune"):
        TunedPlan.from_json({"decay_prune": "triton"})
    # unknown fields are ignored, as in JAX
    assert TunedPlan.from_json({"future_knob": 3}) == JNP_PLAN


def test_shape_class_and_a_cache_of_its_own(monkeypatch, tmp_path):
    for layout in ("hash", "region"):
        cfg, jcfg = _cfg(cooc_layout=layout), _jcfg(cooc_layout=layout)
        assert shape_class(cfg, "cpu") == j_shape_class(jcfg, "cpu", "cpu")
    assert shape_class(_cfg(cooc_layout="region"), "cpu") == \
        "cpu-cpu-q10-c12-s10-region-w8"
    # the same key string in both packages, so two directories
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    monkeypatch.delenv(jautotune.CACHE_ENV, raising=False)
    assert autotune.CACHE_ENV != jautotune.CACHE_ENV
    assert autotune.cache_dir() != jautotune.cache_dir()
    monkeypatch.setenv(jautotune.CACHE_ENV, str(tmp_path / "jax"))
    assert autotune.cache_dir() != tmp_path / "jax"
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "port"))
    assert autotune.cache_path(_cfg(), "cpu") == \
        tmp_path / "port" / "cpu-cpu-q10-c12-s10-hash.json"


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def test_cache_hit_determinism(tmp_path, monkeypatch):
    cfg = _cfg()
    p1 = autotune.tune(cfg, device="cpu", cache=str(tmp_path), repeats=1)
    assert p1.shape_class == shape_class(cfg, "cpu")

    def boom(*a, **k):
        raise AssertionError("cache hit must not re-measure")

    monkeypatch.setattr(autotune, "measure_plan", boom)
    p2 = autotune.tune(cfg, device="cpu", cache=str(tmp_path), repeats=1)
    assert p2 == p1
    # another shape class misses the cache (and here: re-measures)
    with pytest.raises(AssertionError):
        autotune.tune(_cfg(cooc_capacity=1 << 13), device="cpu",
                      cache=str(tmp_path), repeats=1)


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_cpu_measure_plan_times_twins_and_writes_jnp(layout):
    cfg = _cfg(cooc_layout=layout, ingest_quantum=64)
    plan, timings = autotune.measure_plan(cfg, device="cpu", repeats=1)
    assert plan.variants() == JNP_PLAN.variants()
    assert plan.backend == "cpu"
    assert sorted(timings) == sorted(f"{op}:jnp" for op in LAYOUT_OPS[layout])
    assert all(t > 0 for t in timings.values())
    assert not autotune.twin_faster(timings)


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_hot_path_traffic_equals_jax(layout):
    for kw in ({}, dict(cooc_capacity=1 << 14, query_capacity=1 << 13),
               dict(ingest_quantum=0)):
        got = autotune.hot_path_traffic(_cfg(cooc_layout=layout, **kw))
        exp = jautotune.hot_path_traffic(_jcfg(cooc_layout=layout, **kw))
        assert got == exp


def test_hot_path_roofline_equals_jax_at_the_same_peaks():
    traffic = autotune.hot_path_traffic(_cfg())
    for op, t in traffic.items():
        for us in (0.5, 12.0, 3000.0):
            got = roofline.hot_path_roofline(
                op, bytes_touched=t["bytes"], flops=t["flops"],
                measured_us=us, peak=PEAK_FLOPS_F32, hbm=HBM_BW)
            exp = jroofline.hot_path_roofline(
                op, bytes_touched=t["bytes"], flops=t["flops"],
                measured_us=us, peak=PEAK_FLOPS_F32, hbm=HBM_BW)
            assert got == exp
    # the port's default compute peak is the f32 CUDA-core rate
    row = roofline.hot_path_roofline("x", bytes_touched=0.0, flops=67e12,
                                     measured_us=2e6)
    assert row["t_compute_s"] == 1.0 and row["bottleneck"] == "compute"
    assert row["roofline_fraction"] == 0.5


def test_op_kernels_name_launch_counters():
    assert set(OP_KERNELS) == set(HOT_PATH_OPS)
    assert set(OP_KERNELS.values()) <= set(KERNELS)
    for ops in LAYOUT_OPS.values():
        assert set(ops) <= set(HOT_PATH_OPS)


# ---------------------------------------------------------------------------
# the plan in snapshot meta
# ---------------------------------------------------------------------------

def test_port_snapshot_plan_loads_in_jax(tmp_path):
    plan = TunedPlan(ingest_chunk=8192, score_block_rows=32, backend="cpu",
                     shape_class="cpu-cpu-q10-c12-s10-hash")
    eng = _run(_cfg(), _batches(4))
    ckpt = CheckpointManager(str(tmp_path))
    eng.save_snapshot(ckpt, extra_meta={"plan": plan.to_json()})
    assert ckpt.manifest()["meta"]["plan"] == plan.to_json()
    t2, _ = SearchAssistanceEngine.restore_from_snapshot(_cfg(), ckpt,
                                                         device="cpu")
    _bits_equal(t2.state_arrays(), eng.state_arrays())
    # the JAX engine restores the port's snapshot and adopts its plan
    j, _ = JEngine.restore_from_snapshot(_jcfg(), JCheckpointManager(
        str(tmp_path)))
    assert j.cfg.plan == JTunedPlan.from_json(plan.to_json())
    _bits_equal(j.state_arrays(), eng.state_arrays())


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_jax_kernel_plan_snapshot_restores_on_the_cpu(tmp_path, layout):
    """A JAX snapshot made under an all-kernel plan restores into a CPU
    engine bit for bit; the plan stays in the manifest, unread."""
    jplan = j_all_kernel_plan(ingest_chunk=8192, score_block_rows=32,
                              backend="tpu", shape_class="tpu-v5e-x")
    j = JEngine(_jcfg(cooc_layout=layout, plan=jplan))
    for ev in _batches(4):
        j.step(ev)
    ck = JCheckpointManager(str(tmp_path))
    j.save_snapshot(ck)
    port_ck = CheckpointManager(str(tmp_path))
    t, _ = SearchAssistanceEngine.restore_from_snapshot(
        _cfg(cooc_layout=layout), port_ck, device="cpu")
    assert not hasattr(t.cfg, "plan")
    assert TunedPlan.from_json(port_ck.manifest()["meta"]["plan"]) == \
        all_kernel_plan(ingest_chunk=8192, score_block_rows=32,
                        backend="tpu", shape_class="tpu-v5e-x")
    _bits_equal(t.state_arrays(), j.state_arrays())


def test_port_equals_jax_fused_plan_on_a_ragged_batch():
    """209 queries a tick at quantum 64: three full slices and a ragged
    one. The JAX engine fuses two slices a call under ``ingest_chunk``
    128; the port, which reads no plan, ingests one slice a call and
    lands bit for bit on the same state."""
    batches = _batches(3, qpt=209)
    port = _run(_cfg(ingest_quantum=64), batches)
    for plan in (None, JTunedPlan(ingest_chunk=128)):
        j = JEngine(_jcfg(ingest_quantum=64, plan=plan))
        for ev in batches:
            j.step(ev)
        _bits_equal(j.state_arrays(), port.state_arrays())


def test_metrics_surface_tuned_variants(tmp_path):
    plan = TunedPlan(ingest_chunk=8192, score_block_rows=32)
    eng = _run(_cfg(), _batches(7))
    rt_dir = str(tmp_path / "rt")
    CheckpointManager(rt_dir).save(
        5, pack_suggestions(eng.suggestions),
        meta={"tick": 5, "plan": plan.to_json()})
    f = SuggestFrontend(rt_dir)
    f.poll()
    m = f.metrics()
    assert m["tuned_variants"] == plan.variants()
    assert m["tuned_variants"]["ingest_chunk"] == 8192
    plain = str(tmp_path / "plain")
    CheckpointManager(plain).save(1, pack_suggestions(eng.suggestions),
                                  meta={"tick": 1})
    f2 = SuggestFrontend(plain)
    f2.poll()
    assert f2.metrics()["tuned_variants"] is None


def test_serve_assist_autotune_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "cache"))
    scfg = serve_assist.default_configs()[1]
    monkeypatch.setattr(serve_assist, "default_configs", lambda: (
        EngineConfig(query_capacity=1 << 12, cooc_capacity=1 << 13,
                     session_capacity=1 << 10, decay_every=6, rank_every=12,
                     ingest_quantum=256), scfg))
    assert serve_assist.main(["--device", "cpu", "--ticks", "13",
                              "--replicas", "1", "--autotune", "--out",
                              str(tmp_path / "out")]) == 0
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines()
                if x.startswith("[assist] tuned plan: "))
    variants = eval(line.split(": ", 1)[1])
    assert {variants[op] for op in HOT_PATH_OPS} == {"jnp"}
    assert len(list((tmp_path / "cache").glob("cpu-cpu-*-hash.json"))) == 1
    f = SuggestFrontend(str(tmp_path / "out" / "rt"))
    f.poll()
    assert f.metrics()["tuned_variants"] == variants
    st = CheckpointManager(str(tmp_path / "out" / "state" / "rt"))
    assert TunedPlan.from_json(st.manifest()["meta"]["plan"]).variants() \
        == variants
    assert f.metrics()["rt_tick"] == 12

"""The PyTorch port's serving stack against the JAX package's, on the CPU.

``interpolate`` (values and order) and ``background_config``; each
package's ``SuggestFrontend`` serving the directories the other package
wrote (suggestion, background and spelling tables, a firehose log with
compaction bases in its manifest, a JAX ``TunedPlan`` and overload stats
in the snapshot meta): equal ``related``, ``spelling`` and ``metrics()``;
``ServerSet`` routing the scripted replicas of ``tests/test_serverset.py``
as JAX's does (every ``RouteResult``, error, replica call and counter);
the port's ``AssistanceService`` against JAX's on one stream under both
cooc layouts and both decay policies (both engines leaf for leaf under
the parity contract of ``torch_parity.py``, the interpolated table under
the suggestion contract); and JAX-written rt and bg snapshot chains plus
a JAX-written log, recovered by the port's ``recover_service``, equal to
JAX's ``recover_service`` on the same files.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro.core.background import AssistanceService as JService
from repro.core.background import background_config as jbackground_config
from repro.core.background import interpolate as jinterpolate
from repro.core.decay import DecayConfig as JDecayConfig
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.plan import TunedPlan
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.stream import SyntheticStream as JStream
from repro.data.tokenizer import NGramTokenizer as JTokenizer
from repro.distributed.fault_tolerance import \
    CheckpointManager as JCheckpointManager
from repro.serving import serve as jserve
from repro.streaming import FirehoseLogWriter as JLogWriter
from repro.streaming import ReplayConfig as JReplayConfig
from repro.streaming import recover_service as jrecover_service
from repro_torch.core.background import (AssistanceService, background_config,
                                         interpolate)
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.data.tokenizer import NGramTokenizer
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.serving import serve
from repro_torch.streaming import FirehoseLogWriter, ReplayConfig
from repro_torch.streaming import recover_service
from torch_parity import compare_states, compare_suggestions

CPU = torch.device("cpu")
CFG = dict(query_capacity=1 << 11, cooc_capacity=1 << 13,
           session_capacity=1 << 10, session_window=3, decay_every=3,
           prune_every=5, rank_every=4, region_width=16)
STREAM = dict(vocab_size=256, n_users=120, queries_per_tick=96,
              tweets_per_tick=8, tweet_words=3, tweet_grams=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run puts several worker processes on a few cores; torch's
    intra-op threads on top of them oversubscribe the cores, and these
    tests' many small ops then wait on each other. One thread each,
    restored after the module (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(policy="sweep", layout="hash"):
    """(JAX config with a tuned plan, which the port leaves unused; port
    config), and their background configs as ``serve_assist`` derives
    them."""
    j = JEngineConfig(**CFG, cooc_layout=layout,
                      decay=JDecayConfig(policy=policy),
                      plan=TunedPlan(backend="cpu"))
    t = EngineConfig(**CFG, cooc_layout=layout,
                     decay=DecayConfig(policy=policy))
    return (j, t, jbackground_config(j, rank_every_mult=3),
            background_config(t, rank_every_mult=3))


def _batches(n, seed=11):
    stream = JStream(JStreamConfig(**STREAM), seed=seed)
    return [stream.gen_tick(t) for t in range(n)]


def _bits_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _same_fields(jd, td, path=""):
    """Every field of the port's config (nested dicts too) equals JAX's;
    fields the port lacks (``plan``, ``use_kernel``, ...) are not read."""
    for name, value in td.items():
        if isinstance(value, dict):
            _same_fields(jd[name], value, f"{path}{name}.")
        else:
            assert jd[name] == value, path + name


def test_background_config_matches_jax():
    j, t, _, _ = _configs("lazy")
    for kw in ({}, dict(half_life_mult=3.0, rank_every_mult=2)):
        _same_fields(dataclasses.asdict(jbackground_config(j, **kw)),
                     dataclasses.asdict(background_config(t, **kw)))


@pytest.mark.parametrize("alpha,k", [(0.7, 8), (0.5, 3), (1.0, 2)])
def test_interpolate_matches_jax(alpha, k):
    """Seeded random tables whose sources and candidates overlap and whose
    scores tie often: the same dict, values and order."""
    rng = np.random.default_rng(k)
    fps = rng.integers(1, 2**63, 40, dtype=np.uint64)

    def table(n_src):
        return {int(s): [(int(d), float(x)) for d, x in zip(
            rng.choice(fps, size=int(rng.integers(0, 9)), replace=False),
            rng.choice([0.25, 0.5, 1.0, 0.125], size=9))]
            for s in rng.choice(fps, size=n_src, replace=False)}

    rt, bg = table(25), table(30)
    got, exp = interpolate(rt, bg, alpha, k), jinterpolate(rt, bg, alpha, k)
    assert list(got.items()) == list(exp.items())
    assert any(len({s for _, s in v}) < len(v) for v in got.values())


# ---------------------------------------------------------------------------
# Frontends: each package serves the other's directories
# ---------------------------------------------------------------------------

QUERIES = ["steve jobs", "apple", "stay hungry", "ipad", "hadoop",
           "mapreduce", "pig latin"]
TYPOS = {"stave jobs": "steve jobs", "hadop": "hadoop"}
OVERLOAD = {"step_p50_ms": 1.5, "step_p95_ms": 2.5, "step_p99_ms": 4.0,
            "level": 1, "level_name": "shed_rt_rank", "n_shed_events": 3,
            "n_shed_rank_rt": 2, "n_shed_rank_bg": 1, "n_shed_total": 6}
PLANS = {
    "plan": TunedPlan(score_gate="kernel", bucket_topk="kernel",
                      score_block_rows=8, backend="cpu").to_json(),
    "future-plan-field": dict(TunedPlan().to_json(), future_knob=3),
    "bad-plan": dict(TunedPlan().to_json(), region_rank="fast"),
    "no-plan": None,
}


def _tables(fp):
    q = [fp(s) for s in QUERIES]
    rt = {q[0]: [(q[1], 0.9), (q[2], 0.5), (q[3], 0.5)],
          q[4]: [(q[5], 0.7), (q[6], 0.2)]}
    bg = {q[0]: [(q[3], 0.8), (q[1], 0.1)], q[6]: [(q[4], 1.0)]}
    spell = [np.array([fp(w) for w in TYPOS], np.uint64),
             np.array([fp(r) for r in TYPOS.values()], np.uint64),
             np.array([1.0, 1.5])]
    return rt, bg, spell


def _write(root, pkg_serve, ckpt_cls, writer_cls, plan, batches):
    tok = NGramTokenizer()
    rt, bg, spell = _tables(tok.query_fp)
    meta = {"tick": 8, "layout": "hash", "overload": OVERLOAD,
            "maintenance": {"q_live": 12.0, "c_live": 40.0}}
    if plan is not None:
        meta["plan"] = plan
    ckpt_cls(str(root / "rt")).save(8, pkg_serve.pack_suggestions(rt), meta)
    ckpt_cls(str(root / "bg")).save(5, pkg_serve.pack_suggestions(bg),
                                    meta={"log_tick": 6})
    ckpt_cls(str(root / "spell")).save(5, spell)
    w = writer_cls(str(root / "log"), ticks_per_segment=3)
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
    w.close()
    man = root / "log" / "firehose-MANIFEST.json"
    doc = json.loads(man.read_text())
    doc["bases"] = [{"tick": 3}, {"tick": 6}]     # advertised replay floors
    man.write_text(json.dumps(doc))


def _frontend(pkg_serve, tok_cls, root):
    tok = tok_cls()
    for s in QUERIES + list(TYPOS):
        tok.query_fp(s)
    fe = pkg_serve.SuggestFrontend(
        str(root / "rt"), str(root / "bg"), tok, spell_dir=str(root / "spell"),
        log_dir=str(root / "log"))
    fe.stale_lag_ticks = 1     # below the bg lag: one engine catching up
    assert fe.poll()
    return fe


def _served(fe, now):
    return ({q: fe.related(q) for q in QUERIES + ["unknown q"]},
            {q: fe.spelling(q) for q in list(TYPOS) + QUERIES[:2]},
            fe.metrics(now=now), fe.freshness_tick())


@pytest.mark.parametrize("plan", list(PLANS))
def test_frontends_serve_each_others_directories(tmp_path, plan):
    batches = _batches(10)
    _write(tmp_path / "jax", jserve, JCheckpointManager, JLogWriter,
           PLANS[plan], batches)
    _write(tmp_path / "port", serve, CheckpointManager, FirehoseLogWriter,
           PLANS[plan], batches)
    now = time.time() + 5.0
    served = {}
    for d in ("jax", "port"):
        for pkg, fe_serve, tok_cls in (("jax", jserve, JTokenizer),
                                       ("port", serve, NGramTokenizer)):
            served[d, pkg] = _served(_frontend(fe_serve, tok_cls,
                                               tmp_path / d), now)
        assert served[d, "port"] == served[d, "jax"], d
    related, spelling, metrics, fresh = served["port", "port"]
    assert served["jax", "port"][:2] == (related, spelling)
    assert related["steve jobs"][0][0] == "apple"
    assert spelling == {"stave jobs": "steve jobs", "hadop": "hadoop",
                        "steve jobs": None, "apple": None}
    assert fresh == 8 and metrics["log_floor_tick"] == 6
    assert (metrics["rt_lag_ticks"], metrics["bg_lag_ticks"]) == (1, 4)
    assert metrics["shed_level_name"] == "shed_rt_rank"
    assert metrics["n_shed_rank"] == 3
    variants = metrics["tuned_variants"]
    if plan in ("plan", "future-plan-field"):
        assert variants == TunedPlan.from_json(PLANS[plan]).variants()
    else:
        assert variants is None
    for sub in ("rt", "bg", "spell"):
        _bits_equal(CheckpointManager(str(tmp_path / "jax" / sub))
                    .load_arrays()[0],
                    CheckpointManager(str(tmp_path / "port" / sub))
                    .load_arrays()[0])


# ---------------------------------------------------------------------------
# ServerSet: tests/test_serverset.py's scripted replicas through both
# ---------------------------------------------------------------------------

class _Fake:
    """Duck-typed replica: scripted liveness, freshness and faults."""

    def __init__(self, name, tick=None, alive=True, fail=0, delay=0.0):
        self.name = name
        self.alive = alive
        self.tick = tick
        self.fail = fail            # raise on the first `fail` calls (-1: always)
        self.delay = delay
        self.calls = 0

    def freshness_tick(self):
        return self.tick

    def related(self, query, k=8):
        self.calls += 1
        if self.fail == -1 or self.calls <= self.fail:
            raise ConnectionError(f"{self.name} is down")
        if self.delay:
            time.sleep(self.delay)
        return [(self.name, 1.0)]


def _dead_skipped(mod, go):
    ss = mod.ServerSet([_Fake("dead", alive=False), _Fake("live", tick=4)])
    go(ss, "breaking news")
    return [ss]


def _all_dead_or_failing(mod, go):
    a = mod.ServerSet([_Fake("a", alive=False), _Fake("b", alive=False)])
    go(a, "q", info=False)
    b = mod.ServerSet([_Fake("a", fail=-1), _Fake("b", fail=-1)],
                      max_retries=1)
    go(b, "q", info=False)
    return [a, b]


def _freshest_first(mod, go):
    fresh = _Fake("fresh", tick=9)
    a = mod.ServerSet([_Fake("stale", tick=5), fresh, _Fake("mid", tick=7)])
    go(a, "q")
    b = mod.ServerSet([_Fake("unknown"), fresh])
    go(b, "q", info=False)
    return [a, b]


def _hedge_and_staleness(mod, go):
    ss = mod.ServerSet([_Fake("backup", tick=7),
                        _Fake("fresh", tick=9, fail=-1)])
    go(ss, "q")
    return [ss]


def _timeout_hedges(mod, go):
    # the slow replica sleeps twice the timeout: its answer is discarded
    ss = mod.ServerSet([_Fake("slow", tick=9, delay=0.5),
                        _Fake("fast", tick=8)], timeout_s=0.25)
    go(ss, "q")
    return [ss]


def _round_robin(mod, go):
    ss = mod.ServerSet([_Fake("a", tick=5), _Fake("b", tick=5)])
    for _ in range(4):
        go(ss, "q")
    return [ss]


def _breaker(mod, go):
    flaky = _Fake("flaky", tick=9, fail=-1)
    ss = mod.ServerSet([flaky, _Fake("ok", tick=5)], breaker_failures=2,
                       breaker_cooldown=4)
    for _ in range(9):
        go(ss, "q")
    flaky.fail = 0                   # back healthy: the probe closes it
    for _ in range(8):
        go(ss, "q")
    return [ss]


def _retry_with_backoff(mod, go):
    a = mod.ServerSet([_Fake("a", tick=3, fail=1), _Fake("b", tick=3, fail=1)],
                      max_retries=1, backoff_s=0.001)
    go(a, "q")
    b = mod.ServerSet([_Fake("a", tick=3, fail=1), _Fake("b", tick=3, fail=1)],
                      max_retries=0)
    go(b, "q", info=False)
    return [a, b]


def _no_freshness(mod, go):
    ss = mod.ServerSet([_Fake("anon")])
    go(ss, "q")
    return [ss]


def _transcript(mod, scenario):
    events = []

    def go(ss, query, info=True):
        try:
            r = ss.request_info(query) if info else ss.request(query)
        except RuntimeError as e:
            events.append(("raise", str(e)))
            return
        events.append(("ok", dataclasses.asdict(r) if info else r))

    sets = scenario(mod, go)
    for ss in sets:
        events.append(("calls", [(r.name, r.calls) for r in ss.replicas]))
        events.append(("counters", ss.n_requests, ss.n_hedged,
                       ss.n_failures, ss.n_timeouts, ss.n_breaker_skips))
    return events


@pytest.mark.parametrize("scenario", [
    _dead_skipped, _all_dead_or_failing, _freshest_first,
    _hedge_and_staleness, _timeout_hedges, _round_robin, _breaker,
    _retry_with_backoff, _no_freshness], ids=lambda f: f.__name__[1:])
def test_serverset_routes_as_jax(scenario):
    got, exp = _transcript(serve, scenario), _transcript(jserve, scenario)
    assert got == exp
    assert any(e[0] == "ok" for e in got) or scenario is _all_dead_or_failing


def test_serverset_route_result_fields():
    """The port's ``RouteResult`` has JAX's fields, in JAX's order."""
    assert [f.name for f in dataclasses.fields(serve.RouteResult)] == \
        [f.name for f in dataclasses.fields(jserve.RouteResult)]


# ---------------------------------------------------------------------------
# AssistanceService and recover_service against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,layout", [
    ("sweep", "hash"), ("lazy", "hash"), ("sweep", "region"),
    ("lazy", "region")])
def test_service_matches_jax(policy, layout):
    """One stream through both services (13 ticks: rt rank cycles at 4, 8,
    12, the bg engine's at 12): the same ticks rank, both engines agree
    leaf for leaf, and so does the interpolated table."""
    jcfg, tcfg, jbg, tbg = _configs(policy, layout)
    j = JService(jcfg, bg_cfg=jbg)
    t = AssistanceService(tcfg, bg_cfg=tbg, device=CPU)
    for ev, tw in _batches(13, seed=3):
        rj, rt = j.step(ev, tw), t.step(ev, tw)
        assert (rj is None) == (rt is None)
        if rj is not None:
            assert (rj["bg"] is None) == (rt["bg"] is None)
    assert j.bg.n_rank_cycles == t.bg.n_rank_cycles == 1
    flips = compare_states(j.rt.state_arrays(), t.rt.state_arrays(),
                           tcfg.decay.prune_threshold)
    flips += compare_states(j.bg.state_arrays(), t.bg.state_arrays(),
                            tbg.decay.prune_threshold)
    print(f"{policy}/{layout}: {flips} prune flips")
    compare_suggestions(j.rt.suggestions, t.rt.suggestions)
    compare_suggestions(j.bg.suggestions, t.bg.suggestions)
    compare_suggestions(j.suggestions, t.suggestions)


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_port_recovers_jax_written_service(tmp_path, layout):
    """A JAX service logs every tick and snapshots both engines at each rt
    rank cycle (delta-chained), then dies mid-segment; the port's
    ``recover_service`` on its files equals JAX's: the same restored
    steps, chains and replay tails, both engines bit for bit, the same
    tables."""
    jcfg, tcfg, jbg, tbg = _configs("sweep", layout)
    svc = JService(jcfg, bg_cfg=jbg)
    rt_dir, bg_dir, log_dir = (str(tmp_path / d) for d in ("rt", "bg", "log"))
    rt_ck = JCheckpointManager(rt_dir, keep_n=0, full_interval=2)
    bg_ck = JCheckpointManager(bg_dir, keep_n=0, full_interval=2)
    w = JLogWriter(log_dir, ticks_per_segment=3)
    for t, (ev, tw) in enumerate(_batches(14, seed=9)):
        svc.step(ev, tw, log_append=w.append)
        if t % tcfg.rank_every == 0 and t > 0:
            svc.save_snapshot(rt_ck, bg_ck)    # steps 5 full, 9 delta, 13 full
    assert [rt_ck.manifest(s)["kind"] for s in rt_ck.steps()] == \
        ["full", "delta", "full"]
    del w                                       # ticks 12-13 die unsealed
    j, jstats = jrecover_service(
        jcfg, JCheckpointManager(rt_dir), JCheckpointManager(bg_dir),
        log_dir, JReplayConfig(chunk_ticks=4), bg_cfg=jbg,
        rt_step=9, bg_step=5)
    t, tstats = recover_service(
        tcfg, CheckpointManager(rt_dir), CheckpointManager(bg_dir), log_dir,
        ReplayConfig(chunk_ticks=4), bg_cfg=tbg, rt_step=9,
        bg_step=5, device=CPU)
    for e in ("rt", "bg"):
        for key in ("restored_step", "n_ticks", "start_tick", "end_tick",
                    "n_rank_run", "n_rank_suppressed", "restore"):
            assert tstats[e][key] == jstats[e][key], (e, key)
    assert (tstats["rt"]["n_ticks"], tstats["bg"]["n_ticks"]) == (3, 7)
    assert tstats["rt"]["restore"]["chain_len"] == 2
    _bits_equal(j.rt.state_arrays(), t.rt.state_arrays())
    _bits_equal(j.bg.state_arrays(), t.bg.state_arrays())
    compare_suggestions(j.rt.suggestions, t.rt.suggestions)
    compare_suggestions(j.bg.suggestions, t.bg.suggestions)
    compare_suggestions(j.suggestions, t.suggestions)

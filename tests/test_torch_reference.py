"""The port's ReferenceEngine against the JAX package's, and the port's CPU
engine against the port's reference (float64 or the engine's float32 LLR)
through ``parity_report``.

The stream has tweets, decay sweeps every 4 ticks and rank cycles every 8
(17 ticks: four sweeps, two rank cycles). The two references must agree
exactly under each decay kind: the same floats, in the same order.
"""
import math

import pytest

from repro.core.decay import DecayConfig as JDecayConfig
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.reference import ReferenceEngine as JReferenceEngine
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.core.reference import ReferenceEngine, parity_report
from repro_torch.data.stream import StreamConfig, SyntheticStream

CFG = dict(query_capacity=1 << 12, cooc_capacity=1 << 14,
           session_capacity=1 << 11, session_window=4, decay_every=4,
           rank_every=8, session_ttl=6)
STREAM = dict(vocab_size=256, n_users=150, queries_per_tick=128,
              tweets_per_tick=16, tweet_words=4, tweet_grams=6,
              session_ticks=5)
KINDS = {"exp": {}, "linear": dict(kind="linear", linear_slope=0.03),
         "step": dict(kind="step", step_every=6, step_factor=0.6)}


def _ticks(n=17):
    stream = SyntheticStream(StreamConfig(**STREAM), seed=11)
    return [stream.gen_tick(t) for t in range(n)]


@pytest.fixture(scope="module")
def ticks():
    return _ticks()


@pytest.mark.parametrize("kind", list(KINDS))
def test_factor_py_equals_jax(kind):
    d, jd = DecayConfig(**KINDS[kind]), JDecayConfig(**KINDS[kind])
    for dt in (0, 1, 4, 5.5, 6, 12, 40, 200):
        assert d.factor_py(dt) == jd.factor_py(dt)


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_equals_jax_reference(ticks, kind):
    ref = ReferenceEngine(EngineConfig(**CFG,
                                       decay=DecayConfig(**KINDS[kind])))
    jref = JReferenceEngine(JEngineConfig(
        **CFG, decay=JDecayConfig(**KINDS[kind])))
    for ev, tw in ticks:
        ref.step(ev, tw)
        jref.step(ev, tw)
    assert ref.tick == jref.tick == len(ticks)
    assert ref.q == jref.q and len(ref.q) > 100
    assert ref.cooc == jref.cooc and len(ref.cooc) > 1000
    assert {s: list(d) for s, d in ref.sessions.items()} == \
        {s: list(d) for s, d in jref.sessions.items()}
    assert ref.sess_tick == jref.sess_tick
    # the short TTL and session epochs evict sessions at the sweeps
    seen = {int(s) for ev, _ in ticks for s, v in zip(ev.sess_fp, ev.valid)
            if v}
    assert 0 < len(ref.sess_tick) < len(seen)
    assert ref.suggestions == jref.suggestions and len(ref.suggestions) > 50
    assert all(math.isfinite(s) for lst in ref.suggestions.values()
               for _, s in lst)


def _engine_and_reference(ticks, llr_f32=False, **kw):
    cfg = EngineConfig(**{**CFG, **kw})
    eng = SearchAssistanceEngine(cfg, device="cpu")
    ref = ReferenceEngine(cfg, llr_f32=llr_f32)
    for ev, tw in ticks:
        eng.step(ev, tw)
        ref.step(ev, tw)
    return eng, ref


@pytest.mark.parametrize("llr", ["float64", "float32"])
@pytest.mark.parametrize("layout", ["hash", "region"])
def test_cpu_engine_holds_the_contract_against_the_reference(ticks, layout,
                                                             llr):
    kw = dict(cooc_layout=layout)
    if layout == "region":      # ample regions: no chain-full drops
        kw.update(cooc_capacity=1 << 16, region_width=64)
    eng, ref = _engine_and_reference(ticks, llr_f32=llr == "float32", **kw)
    rep = parity_report(eng, ref)
    assert rep["suggestions"]["reference_llr"] == llr
    assert rep["ok"], rep["faults"]
    assert rep["drops"] == {"qstore": 0, "cooc": 0, "sessions": 0}
    for store in ("qstore", "cooc"):
        r = rep[store]
        assert r["engine"] == r["reference"] > 100
        assert r["only_engine"] == r["only_reference"] == r["flips"] == 0
        assert r["weight_max_rel"] < 1e-5 and r["count_max_rel"] == 0.0
    assert rep["sessions"]["engine"] == rep["sessions"]["reference"] > 0
    sg = rep["suggestions"]
    assert sg["engine_sources"] == sg["reference_sources"] > 50
    assert sg["agree_share"] == 1.0 and sg["score_out"] == 0
    # sources with more gate-passing pairs than the bucket arena's rows
    # are counted apart (here every one of them still agrees)
    assert sg["capped"]["bucket_rows"] > 0 and sg["capped_disagree"] == 0
    assert sg["capped"]["source_cap"] == sg["capped"]["arena"] == 0


def test_parity_report_names_what_breaks_the_contract(ticks):
    eng, ref = _engine_and_reference(ticks[:9])
    a = next(iter(ref.cooc))
    ref.cooc[a][0] *= 1.01                      # one weight 1% off
    del ref.q[next(k for k, e in ref.q.items() if e[0] > 1.0)]
    ref.sessions[next(iter(ref.sessions))].append((12345, 0))
    src = next(iter(ref.suggestions))
    ref.suggestions[src] = [(d, s + 1.0) for d, s in ref.suggestions[src]]
    rep = parity_report(eng, ref)
    assert not rep["ok"]
    assert rep["cooc"]["weight_out"] == 1
    assert rep["qstore"]["only_engine"] == 1 and rep["qstore"]["flips"] == 0
    assert rep["sessions"]["mismatched"] == 1
    assert rep["suggestions"]["score_out"] + \
        rep["suggestions"]["capped_disagree"] == 1
    assert any(f.startswith("qstore: keys differ") for f in rep["faults"])


@pytest.mark.parametrize("total_c", [2e3, 4.4e5, 8e6])
def test_llr_float32_is_the_engines_llr_lane(total_c):
    """The reference's float32 LLR equals the CPU engine's LLR lane bit
    for bit (same order; logs correctly rounded, or the CPU's own), up to
    a deployment's totals."""
    import numpy as np
    import torch
    from repro_torch.core.reference import llr_float32
    from repro_torch.kernels.assoc_score import assoc_lanes
    rng = np.random.default_rng(int(total_c))
    c_ab = rng.integers(1, 30, 4000).astype(np.float64)
    c_a = c_ab + rng.integers(0, int(total_c) // 8, 4000)
    c_b = c_ab + rng.integers(0, int(total_c) // 3, 4000)
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    ones = f(np.ones(4000))
    lane = assoc_lanes(ones, f(c_ab), ones, ones, f(c_a), f(c_b), f(1.0),
                       f(total_c))[2].double().numpy()
    got = llr_float32(c_ab, c_a, c_b, total_c)
    assert got.dtype == np.float64 and (got == lane).all()
    assert (got > 0).mean() > 0.9
    # the engine device's log, given: here the CPU's, the same lane
    torch_log = llr_float32(c_ab, c_a, c_b, total_c,
                            log=lambda v: torch.log(torch.from_numpy(v))
                            .numpy())
    assert (torch_log == lane).all()

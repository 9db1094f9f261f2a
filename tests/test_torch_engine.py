"""The PyTorch port's engine (CPU) against the JAX engine and ReferenceEngine.

Same stream and configuration as ``tests/test_engine.py`` (seed 11, 9
ticks: two decay cycles and one rank cycle), compared leaf by leaf on
``state_arrays()`` under the contract in ``torch_parity.py``.
"""
import numpy as np
import pytest
import torch

from repro.core.decay import DecayConfig as JDecayConfig
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SearchAssistanceEngine as JEngine
from repro.core.hashing import join_fp
from repro.core.reference import ReferenceEngine
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.stream import SyntheticStream as JStream
from repro_torch.core import stores as tstores
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.data.stream import StreamConfig, SyntheticStream
from torch_parity import compare_states, compare_suggestions

CFG = dict(query_capacity=1 << 12, cooc_capacity=1 << 14,
           session_capacity=1 << 11, session_window=4, decay_every=4,
           rank_every=8)
STREAM = dict(vocab_size=256, n_users=150, queries_per_tick=128,
              tweets_per_tick=16, tweet_words=4, tweet_grams=6)
THRESH = DecayConfig().prune_threshold


def _run(n_ticks=9, lazy=False):
    jdk = dict(decay=JDecayConfig(policy="lazy"), prune_every=4) if lazy else {}
    tdk = dict(decay=DecayConfig(policy="lazy"), prune_every=4) if lazy else {}
    jstream = JStream(JStreamConfig(**STREAM), seed=11)
    tstream = SyntheticStream(StreamConfig(**STREAM), seed=11)
    j = JEngine(JEngineConfig(**CFG, **jdk))
    t = SearchAssistanceEngine(EngineConfig(**CFG, **tdk), device="cpu")
    ref = ReferenceEngine(JEngineConfig(**CFG)) if not lazy else None
    for k in range(n_ticks):
        ev, tw = jstream.gen_tick(k)
        j.step(ev, tw)
        t.step(*tstream.gen_tick(k))
        if ref is not None:
            ref.step(ev, tw)
    return j, t, ref


@pytest.fixture(scope="module")
def engines():
    return _run()


def test_port_state_matches_jax_engine(engines):
    j, t, _ = engines
    flips = compare_states(j.state_arrays(), t.state_arrays(), THRESH)
    print(f"prune flips vs JAX engine: {flips}")
    assert flips == 0


def test_port_suggestions_match_jax_engine(engines):
    j, t, _ = engines
    assert t.n_rank_cycles == j.n_rank_cycles == 1
    assert t.n_decay_cycles == j.n_decay_cycles == 2
    share = compare_suggestions(j.suggestions, t.suggestions)
    print(f"top-3 identity agreement vs JAX engine: {share:.4f}")


def test_port_matches_reference_engine(engines):
    _, t, ref = engines
    q = tstores.export_live(t.state.qstore)
    tq = {int(f): (float(w), float(c)) for f, w, c in
          zip(join_fp(q["key_hi"], q["key_lo"]), q["weight"], q["count"])}
    assert set(tq) == set(ref.q)
    for f, (w, c) in tq.items():
        np.testing.assert_allclose(w, ref.q[f][0], rtol=2e-3)
        np.testing.assert_allclose(c, ref.q[f][1], rtol=1e-5)
    c = tstores.export_live(t.state.cooc)
    tc = {(int(a), int(b)): (float(w), float(n)) for a, b, w, n in zip(
        join_fp(c["src_hi"], c["src_lo"]), join_fp(c["dst_hi"], c["dst_lo"]),
        c["weight"], c["count"])}
    assert set(tc) == set(ref.cooc)
    for k, (w, n) in tc.items():
        np.testing.assert_allclose(w, ref.cooc[k][0], rtol=2e-3)
        np.testing.assert_allclose(n, ref.cooc[k][1], rtol=1e-5)
    compare_suggestions(ref.suggestions, t.suggestions)


def test_port_no_drops(engines):
    _, t, _ = engines
    for table in (t.state.qstore, t.state.cooc, t.state.sessions):
        assert int(table.n_dropped) == 0


def test_cross_load_jax_state_into_port():
    """JAX state at tick 5 -> load_state_arrays -> both step 4 more ticks."""
    jstream = JStream(JStreamConfig(**STREAM), seed=11)
    tstream = SyntheticStream(StreamConfig(**STREAM), seed=11)
    j = JEngine(JEngineConfig(**CFG))
    for k in range(5):
        j.step(*jstream.gen_tick(k))
        tstream.gen_tick(k)
    t = SearchAssistanceEngine(EngineConfig(**CFG), device="cpu")
    t.load_state_arrays(j.state_arrays())
    np.testing.assert_equal(t.state_arrays(), j.state_arrays())
    for k in range(5, 9):
        j.step(*jstream.gen_tick(k))
        t.step(*tstream.gen_tick(k))
    flips = compare_states(j.state_arrays(), t.state_arrays(), THRESH)
    print(f"prune flips after cross-load: {flips}")
    assert flips == 0
    compare_suggestions(j.suggestions, t.suggestions)


def test_lazy_policy_matches_jax_engine():
    j, t, _ = _run(lazy=True)
    assert t.n_prune_cycles == j.n_prune_cycles == 2
    assert t.n_decay_cycles == j.n_decay_cycles == 0
    flips = compare_states(j.state_arrays(), t.state_arrays(), THRESH)
    print(f"prune flips, lazy policy: {flips}")
    compare_suggestions(j.suggestions, t.suggestions)


def test_state_arrays_roundtrip_and_step_many():
    """load_state_arrays(state_arrays()) is exact, and step_many over the
    same ticks equals step() tick by tick (ranking aside)."""
    from repro_torch.core.engine import TickStack
    from repro_torch.core.hashing import from_np_u32, split_fp
    stream = SyntheticStream(StreamConfig(**STREAM), seed=5)
    ticks = [stream.gen_tick(k) for k in range(6)]
    cfg = EngineConfig(**{**CFG, "rank_every": 0})
    a = SearchAssistanceEngine(cfg, device="cpu")
    for ev, tw in ticks:
        a.step(ev, tw)
    u = lambda x: torch.stack([from_np_u32(v, "cpu") for v in x])
    sh = [split_fp(ev.sess_fp) for ev, _ in ticks]
    qh = [split_fp(ev.q_fp) for ev, _ in ticks]
    gh = [split_fp(tw.grams) for _, tw in ticks]
    stack = TickStack(
        u([s[0] for s in sh]), u([s[1] for s in sh]),
        u([q[0] for q in qh]), u([q[1] for q in qh]),
        torch.tensor(np.stack([ev.src for ev, _ in ticks])),
        torch.tensor(np.stack([ev.valid for ev, _ in ticks])),
        u([g[0] for g in gh]), u([g[1] for g in gh]),
        torch.tensor(np.stack([tw.valid for _, tw in ticks])))
    b = SearchAssistanceEngine(cfg, device="cpu")
    b.step_many(stack)
    assert b.n_decay_cycles == a.n_decay_cycles
    np.testing.assert_equal(a.state_arrays(), b.state_arrays())
    c = SearchAssistanceEngine(cfg, device="cpu")
    c.load_state_arrays(b.state_arrays())
    np.testing.assert_equal(c.state_arrays(), b.state_arrays())


@pytest.mark.parametrize("log2c", range(14, 25))
def test_region_width_matches_jax(log2c):
    from repro.core.plan import default_region_width
    cfg = EngineConfig(cooc_layout="region", cooc_capacity=1 << log2c)
    assert cfg.region_w == default_region_width(1 << log2c)

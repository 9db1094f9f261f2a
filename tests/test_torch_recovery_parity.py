"""The PyTorch port's recovery path against the JAX package's, on the CPU.

Both packages read what the other writes: codec blobs (byte-identical
encodings), ``diff_leading_rows`` / ``apply_row_delta``, full + delta
snapshot chains (a JAX engine's chain restores into the port bit for bit
and both go on equal under the parity contract of ``torch_parity.py``,
and the reverse, under both cooc layouts) and firehose-log directories (a
port recovery replays a JAX-written log). Also ``ranking_cycle_lexsort``
against the JAX one, the port's two ranking cycles against it, and
``repro_torch.breaking_news`` at a cut-down configuration.
"""
import numpy as np
import pytest

from repro.core import ranking as jranking
from repro.core import stores as jstores
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SearchAssistanceEngine as JEngine
from repro.core.plan import TunedPlan
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.stream import SyntheticStream as JStream
from repro.distributed.fault_tolerance import \
    CheckpointManager as JCheckpointManager
from repro.streaming import codec as jcodec
from repro.streaming import log as jlog
from repro_torch import breaking_news
from repro_torch.core import ranking, stores
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.data.stream import StreamConfig
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.streaming import codec, log
from repro_torch.streaming import ReplayConfig, recover_engine
from torch_parity import compare_states, compare_suggestions

CFG = dict(query_capacity=1 << 11, cooc_capacity=1 << 13,
           session_capacity=1 << 10, session_window=3, decay_every=3,
           rank_every=4, region_width=16)
STREAM = dict(vocab_size=256, n_users=120, queries_per_tick=96,
              tweets_per_tick=8, tweet_words=3, tweet_grams=4)
THRESH = DecayConfig().prune_threshold


def _configs(layout="hash"):
    """(JAX config with a tuned plan, which the port leaves unused; port
    config) for one layout, sweep policy."""
    return (JEngineConfig(**CFG, cooc_layout=layout,
                          plan=TunedPlan(backend="cpu")),
            EngineConfig(**CFG, cooc_layout=layout))


def _batches(n, seed=11):
    stream = JStream(JStreamConfig(**STREAM), seed=seed)
    return [stream.gen_tick(t) for t in range(n)]


def _bits_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _payload(rng):
    fps = rng.integers(1, 2**63, 40, dtype=np.uint64)
    return {"ticks": np.arange(3, dtype=np.int64),
            "sess_fp": fps[rng.integers(0, 5, (3, 50))],   # repeats
            "q_fp": fps[rng.integers(0, 40, (3, 50))],
            "src": rng.integers(0, 3, (3, 50)).astype(np.int32),
            "q_valid": rng.random((3, 50)) < 0.9,
            "grams": fps[rng.integers(0, 40, (3, 4, 6))],
            "t_valid": np.ones((3, 4), bool),
            "w": np.array([1.5, np.nan, -0.0, np.inf], np.float32)}


@pytest.mark.parametrize("name", ["raw", "zlib", "fpx-zlib"])
def test_codec_blobs_cross_decode(name):
    payload = _payload(np.random.default_rng(3))
    jblob, jinfo = jcodec.encode_payload(payload, codec=name)
    tblob, tinfo = codec.encode_payload(payload, codec=name)
    assert jblob == tblob and jinfo == tinfo
    for dec in (jcodec, codec):
        out, info = dec.decode_payload(tblob)
        _bits_equal(out, payload)
        assert info["codec"] == name


def test_diff_and_apply_rows_match_jax():
    rng = np.random.default_rng(5)
    cases = [rng.random(500).astype(np.float32),
             rng.integers(0, 2**32, 300, dtype=np.uint32),
             rng.integers(0, 9, (200, 5)).astype(np.int32)]
    for prev in cases:
        new = prev.copy()
        hit = rng.random(prev.shape[0]) < 0.1
        new[hit] = new[hit] + 1
        if new.dtype == np.float32:
            prev[7] = new[7] = np.nan          # NaN != NaN: adds the row
        idx = stores.diff_leading_rows(prev, new)
        np.testing.assert_array_equal(idx, jstores.diff_leading_rows(prev,
                                                                     new))
        assert idx.dtype == np.int64
        got = stores.apply_row_delta(prev.copy(), idx, new[idx])
        exp = jstores.apply_row_delta(prev.copy(), idx, new[idx])
        assert got.tobytes() == exp.tobytes() == new.tobytes()
    with pytest.raises(ValueError):
        stores.diff_leading_rows(cases[0], cases[0][:3])


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_jax_snapshot_chain_restores_into_port(tmp_path, layout):
    jcfg, tcfg = _configs(layout)
    batches = _batches(10)
    j = JEngine(jcfg)
    ck = JCheckpointManager(str(tmp_path), keep_n=0, full_interval=2)
    for t in range(6):
        if j.step(*batches[t]) is not None or t == 5:
            j.save_snapshot(ck)               # step 5 full, step 6 delta
    assert [ck.manifest(s)["kind"] for s in ck.steps()] == ["full", "delta"]
    assert "plan" in ck.manifest()["meta"]
    tck = CheckpointManager(str(tmp_path))
    t_eng, log_tick = SearchAssistanceEngine.restore_from_snapshot(
        tcfg, tck, device="cpu")
    assert log_tick == 6 and tck.last_restore["chain_len"] == 2
    _bits_equal(t_eng.state_arrays(), j.state_arrays())
    for t in range(6, 10):                    # a rank cycle at tick 8
        j.step(*batches[t])
        t_eng.step(*batches[t])
    assert compare_states(j.state_arrays(), t_eng.state_arrays(),
                          THRESH) == 0
    compare_suggestions(j.suggestions, t_eng.suggestions)


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_port_snapshot_chain_restores_into_jax(tmp_path, layout):
    jcfg, tcfg = _configs(layout)
    batches = _batches(10, seed=12)
    t_eng = SearchAssistanceEngine(tcfg, device="cpu")
    tck = CheckpointManager(str(tmp_path), keep_n=0, full_interval=2)
    for t in range(6):
        if t_eng.step(*batches[t]) is not None or t == 5:
            t_eng.save_snapshot(tck)
    assert [tck.manifest(s)["kind"] for s in tck.steps()] == ["full", "delta"]
    j, log_tick = JEngine.restore_from_snapshot(
        jcfg, JCheckpointManager(str(tmp_path)))
    assert log_tick == 6
    _bits_equal(j.state_arrays(), t_eng.state_arrays())
    for t in range(6, 10):
        j.step(*batches[t])
        t_eng.step(*batches[t])
    assert compare_states(j.state_arrays(), t_eng.state_arrays(),
                          THRESH) == 0
    compare_suggestions(j.suggestions, t_eng.suggestions)


def test_log_segments_cross_read(tmp_path):
    """Segments written by either package read back equal in the other; a
    port writer appends to a JAX-written log."""
    batches = _batches(8)
    jw = jlog.FirehoseLogWriter(str(tmp_path), ticks_per_segment=3)
    for t in range(4):
        jw.append(t, *batches[t])
    jw.close()
    tw = log.FirehoseLogWriter(str(tmp_path), ticks_per_segment=3)
    for t in range(4, 8):
        tw.append(t, *batches[t])
    tw.close()
    for reader in (jlog.FirehoseLogReader(str(tmp_path)),
                   log.FirehoseLogReader(str(tmp_path))):
        assert [(s.first, s.last) for s in reader.segments] == \
            [(0, 2), (3, 3), (4, 6), (7, 7)]
        got = list(reader.read_ticks(0))
        assert [t for t, _, _ in got] == list(range(8))
        for (_, ev, twt), (oev, otw) in zip(got, batches):
            for a, b in ((ev.sess_fp, oev.sess_fp), (ev.q_fp, oev.q_fp),
                         (ev.src, oev.src), (ev.valid, oev.valid),
                         (twt.grams, otw.grams), (twt.valid, otw.valid)):
                np.testing.assert_array_equal(a, b)


def test_port_recovers_from_jax_written_snapshot_and_log(tmp_path):
    """A JAX engine logs every tick and snapshots at its rank cycles, then
    dies; the port restores its chain and replays its log, and matches the
    JAX engine that went on, under the parity contract."""
    jcfg, tcfg = _configs("hash")
    batches = _batches(11, seed=4)
    j = JEngine(jcfg)
    ck = JCheckpointManager(str(tmp_path / "ck"), full_interval=2)
    w = jlog.FirehoseLogWriter(str(tmp_path / "log"), ticks_per_segment=3)
    for t in range(11):
        w.append(t, *batches[t])
        if j.step(*batches[t]) is not None:
            j.save_snapshot(ck)               # steps 5 full, 9 delta
    w.close()
    eng, stats = recover_engine(tcfg, CheckpointManager(str(tmp_path / "ck")),
                                str(tmp_path / "log"),
                                ReplayConfig(chunk_ticks=4), device="cpu")
    assert stats["restored_step"] == 9 and stats["n_ticks"] == 2
    assert stats["restore"]["chain_len"] == 2
    assert compare_states(j.state_arrays(), eng.state_arrays(), THRESH) == 0
    j.run_rank_cycle()
    compare_suggestions(j.suggestions, eng.suggestions)


def _pair():
    """A JAX engine after 9 ticks and a port engine loaded with its state."""
    jcfg, tcfg = _configs("hash")
    j = JEngine(jcfg)
    for ev, tw in _batches(9, seed=6):
        j.step(ev, tw)
    t = SearchAssistanceEngine(tcfg, device="cpu")
    t.load_state_arrays(j.state_arrays())
    return j, t


@pytest.mark.parametrize("compact_frac", [0.5, 1.0, 1e-3])
def test_ranking_cycle_lexsort_matches_jax(compact_frac):
    j, t = _pair()
    jt = jranking.ranking_cycle_lexsort(
        j.state.cooc, j.state.qstore,
        jranking.RankConfig(compact_frac=compact_frac))
    tt = ranking.ranking_cycle_lexsort(
        t.state.cooc, t.state.qstore, ranking.RankConfig(),
        compact_frac=compact_frac)
    assert int(tt.n_rows) == int(jt.n_rows) > 0
    assert int(tt.n_overflow) == int(jt.n_overflow)
    assert (int(tt.n_overflow) > 0) == (compact_frac < 0.01)
    compare_suggestions(jranking.suggestions_to_host(jt),
                        ranking.suggestions_to_host(tt))


def _match_up_to_ties(ta, tb, rtol):
    """Same sources and per-source score multisets; destinations agree
    except within the score group tied at the top-k cut (as
    ``tests/test_ranking_topk.py`` holds the JAX cycles)."""
    sa, sb = ranking.suggestions_to_host(ta), ranking.suggestions_to_host(tb)
    assert set(sa) == set(sb) and sa
    assert int(ta.n_rows) == int(tb.n_rows)
    for f in sa:
        ra, rb = sa[f], sb[f]
        assert len(ra) == len(rb)
        xa = sorted((s for _, s in ra), reverse=True)
        xb = sorted((s for _, s in rb), reverse=True)
        np.testing.assert_allclose(xa, xb, rtol=rtol, atol=1e-5)
        band = xa[-1] + rtol * abs(xa[-1]) + 1e-5
        assert {d for d, s in ra if s > band} == {d for d, s in rb
                                                  if s > band}


def test_port_cycles_match_port_lexsort():
    """The segmented hash cycle and the region cycle (over a region store
    fed the same stream) against the lexsort reference."""
    _, hcfg = _configs("hash")
    _, rcfg = _configs("region")
    h = SearchAssistanceEngine(hcfg, device="cpu")
    r = SearchAssistanceEngine(rcfg, device="cpu")
    for ev, tw in _batches(7, seed=8):
        h.step(ev, tw)
        r.step(ev, tw)
    assert int(h.state.cooc.n_dropped) == int(r.state.cooc.n_dropped) == 0
    lex = ranking.ranking_cycle_lexsort(h.state.cooc, h.state.qstore,
                                        hcfg.rank)
    assert int(lex.n_overflow) == 0
    _match_up_to_ties(ranking.ranking_cycle(h.state.cooc, h.state.qstore,
                                            hcfg.rank), lex, 2e-3)
    _match_up_to_ties(ranking.ranking_cycle_region(
        r.state.cooc, r.state.qstore, rcfg.rank), lex, 5e-3)


def test_breaking_news_on_the_cpu(tmp_path):
    """The Figure-1 scenario at a cut-down size (512 queries a tick): the
    related terms surface within the paper's 10 minutes, survive the
    crash, and are in the final list."""
    lines = []
    res = breaking_news.run(
        "cpu", StreamConfig(vocab_size=1024, queries_per_tick=512,
                            tweets_per_tick=32, tick_seconds=30.0),
        EngineConfig(query_capacity=1 << 13, cooc_capacity=1 << 15,
                     session_capacity=1 << 13, decay_every=4,
                     rank_every=10),
        out_dir=str(tmp_path), log=lines.append)
    assert res["latency_min"] is not None
    assert res["latency_min"] <= breaking_news.TARGET_MIN
    rec = res["recovery"]
    assert rec["n_ticks"] > 0 and rec["restored_step"] > 0
    assert rec["n_rank_run"] == 1 and not rec["restore"]["fell_back"]
    assert res["kept"]
    assert any(term in dict(res["final"]) for term in res["event_terms"])
    assert any("CRASH + recovery" in line for line in lines)

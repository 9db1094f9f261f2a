"""Crash recovery on the PyTorch port (§4.2 rewind/catch-up), on the CPU.

Ports the JAX package's recovery tests that need neither the background
engine nor overload control: the segmented firehose log (round trip, seek,
rotation, retention, torn tail, retries), snapshot round trips, the
per-tick ``ingest_many`` against live stepping, crash -> restore -> replay
at every segment boundary (both decay policies, bit for bit, equal
suggestions), replay-mode rank suppression and handoff, the three log-gap
cases, the leader-gated and epoch-fenced writer, and the delta-snapshot
chain (delta == full under both layouts, corrupt-delta and torn-manifest
fallback, retention that never strands a delta, a shape change forcing a
full). Beyond the JAX tests: a CPU save/mutate/save cycle showing the
delta shadow owns its bytes (the port's stores mutate in place and
``.numpy()`` of a CPU tensor aliases it), the refusal of leaves npz
cannot store (bfloat16) and of raw-viewed snapshots, and the refusal of a
log that advertises a compaction base.

Imports torch and ``repro_torch`` only.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import (EngineConfig, SearchAssistanceEngine,
                                     TickStack, ingest_many)
from repro_torch.core.hashing import from_np_u32, split_fp
from repro_torch.data.stream import StreamConfig, SyntheticStream
from repro_torch.distributed.fault_tolerance import (CheckpointManager,
                                                     ReplicaGroup,
                                                     corrupt_snapshot)
from repro_torch.streaming import (CatchUpController, FirehoseLogReader,
                                   FirehoseLogWriter, ReplayConfig,
                                   WriterFencedError, chunk_to_stack,
                                   corrupt_segment, decode_payload, flaky_io,
                                   kill_writer_mid_segment, log_epoch,
                                   recover_engine)

CPU = torch.device("cpu")


def _cfg(policy="lazy", **kw):
    base = dict(query_capacity=1 << 11, cooc_capacity=1 << 13,
                session_capacity=1 << 10, session_window=3,
                decay_every=4, prune_every=6, rank_every=5,
                region_width=16, decay=DecayConfig(policy=policy))
    base.update(kw)
    return EngineConfig(**base)


def _engine(cfg):
    return SearchAssistanceEngine(cfg, device=CPU)


def _recover(cfg, ckpt, log_dir, rcfg=ReplayConfig(), **kw):
    return recover_engine(cfg, ckpt, log_dir, rcfg, device=CPU, **kw)


def _batches(n, seed=11, tweets=8):
    stream = SyntheticStream(
        StreamConfig(vocab_size=256, n_users=120, queries_per_tick=96,
                     tweets_per_tick=tweets, tweet_words=3, tweet_grams=4),
        seed=seed)
    return [stream.gen_tick(t) for t in range(n)]


def _stack(batches, queries_only=False) -> TickStack:
    u32 = lambda a: [from_np_u32(x, CPU) for x in split_fp(a)]
    s_hi, s_lo = u32(np.stack([b[0].sess_fp for b in batches]))
    q_hi, q_lo = u32(np.stack([b[0].q_fp for b in batches]))
    R = len(batches)
    if queries_only:
        g_hi = g_lo = torch.zeros((R, 0, 0), dtype=torch.int32)
        t_valid = torch.zeros((R, 0), dtype=torch.bool)
    else:
        g_hi, g_lo = u32(np.stack([b[1].grams for b in batches]))
        t_valid = torch.tensor(np.stack([b[1].valid for b in batches]))
    return TickStack(
        s_hi, s_lo, q_hi, q_lo,
        torch.tensor(np.stack([b[0].src for b in batches]).astype(np.int32)),
        torch.tensor(np.stack([b[0].valid for b in batches])),
        g_hi, g_lo, t_valid)


def _arrays(x):
    return x.state_arrays() if isinstance(x, SearchAssistanceEngine) else x


def _assert_states_equal(a, b):
    """Leaf for leaf, dtype, shape and bytes (engines or state_arrays())."""
    sa, sb = _arrays(a), _arrays(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
        assert sa[k].tobytes() == sb[k].tobytes(), f"state {k}"


def _copy_arrays(eng):
    """A host copy of the engine's state that owns its bytes."""
    return {k: v.copy() for k, v in eng.state_arrays().items()}


# ---------------------------------------------------------------------------
# Log
# ---------------------------------------------------------------------------

def test_log_roundtrip_and_seek(tmp_path):
    batches = _batches(10)
    w = FirehoseLogWriter(str(tmp_path), ticks_per_segment=4)
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
    w.close()   # seals the partial tail segment (ticks 8-9)
    r = FirehoseLogReader(str(tmp_path))
    assert [(s.first, s.last) for s in r.segments] == [(0, 3), (4, 7), (8, 9)]
    assert (r.first_tick(), r.last_tick()) == (0, 9)
    for (t, ev, tw), (oev, otw) in zip(r.read_ticks(0), batches):
        np.testing.assert_array_equal(ev.q_fp, oev.q_fp)
        np.testing.assert_array_equal(ev.sess_fp, oev.sess_fp)
        np.testing.assert_array_equal(ev.src, oev.src)
        np.testing.assert_array_equal(tw.grams, otw.grams)
    ticks = []
    for chunk in r.read_chunks(5, chunk_ticks=3):
        ticks.extend(chunk.ticks.tolist())
    assert ticks == [5, 6, 7, 8, 9]
    w2 = FirehoseLogWriter(str(tmp_path), ticks_per_segment=4)
    with pytest.raises(ValueError):
        w2.append(9, *batches[0])


def test_log_rotation_and_retention(tmp_path):
    w = FirehoseLogWriter(str(tmp_path), ticks_per_segment=2,
                          keep_segments=2)
    for t, (ev, tw) in enumerate(_batches(10)):
        w.append(t, ev, tw)
    r = FirehoseLogReader(str(tmp_path))
    assert [(s.first, s.last) for s in r.segments] == [(6, 7), (8, 9)]
    on_disk = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(on_disk) == 2, "retention must unlink old segment files"


def test_torn_tail_truncation(tmp_path):
    batches = _batches(8)
    w = FirehoseLogWriter(str(tmp_path), ticks_per_segment=3)
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
    torn = kill_writer_mid_segment(w)    # ticks 6, 7 were buffered
    assert torn is not None and os.path.exists(tmp_path / torn)
    with pytest.raises(RuntimeError):
        w.append(8, *batches[0])
    r = FirehoseLogReader(str(tmp_path))
    assert r.last_tick() == 5 and r.n_unmanifested_files == 1
    corrupt_segment(str(tmp_path), r.segments[1])
    r.refresh()
    assert r.last_tick() == 2 and r.n_truncated_segments == 1
    assert r.repair() >= 1
    assert FirehoseLogReader(str(tmp_path)).n_unmanifested_files == 0


def test_reader_retries_transient_io_errors(tmp_path):
    batches = _batches(8)
    w = FirehoseLogWriter(str(tmp_path), ticks_per_segment=4)
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
    w.close()
    r = FirehoseLogReader(str(tmp_path), io_backoff_s=1e-4)
    flaky_io(r, ("_read_bytes",), n_failures=1)
    r.refresh()
    assert r.n_io_retries == 1 and r.n_truncated_segments == 0
    assert (r.first_tick(), r.last_tick()) == (0, 7)
    flaky_io(r, ("_read_bytes",), n_failures=2)
    got = list(r.read_ticks(0))
    assert [t for t, _, _ in got] == list(range(8))
    np.testing.assert_array_equal(got[5][1].q_fp, batches[5][0].q_fp)
    assert r.n_io_retries == 3
    flaky_io(r, ("_read_bytes",), n_failures=100)
    r.refresh()
    assert r.segments == [] and r.n_truncated_segments == 2
    r._flaky_io_undo()
    assert r.refresh().last_tick() == 7
    flaky_io(r, ("_read_bytes",), n_failures=100)
    with pytest.raises(OSError):
        list(r.read_ticks(0))


def test_recovery_replay_through_flaky_io(tmp_path):
    cfg = _cfg("lazy")
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    w = FirehoseLogWriter(str(tmp_path / "log"), ticks_per_segment=3)
    live = _engine(cfg)
    live.save_snapshot(ckpt)                      # offset 0: replay all
    for t, (ev, tw) in enumerate(_batches(8)):
        w.append(t, ev, tw)
        live.step(ev, tw)
    w.close()
    reader = FirehoseLogReader(str(tmp_path / "log"), io_backoff_s=1e-4)
    flaky_io(reader, ("_read_bytes",), n_failures=2)
    eng = _engine(cfg)
    stats = CatchUpController(eng, reader,
                              ReplayConfig(chunk_ticks=4)).catch_up()
    assert stats["n_ticks"] == 8 and reader.n_io_retries >= 1
    _assert_states_equal(live, eng)


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["hash", "region"])
def test_engine_state_snapshot_roundtrip(tmp_path, layout):
    cfg = _cfg(cooc_layout=layout)
    eng = _engine(cfg)
    for ev, tw in _batches(4):
        eng.step(ev, tw)
    ckpt = CheckpointManager(str(tmp_path))
    eng.save_snapshot(ckpt)
    restored, log_tick = SearchAssistanceEngine.restore_from_snapshot(
        cfg, ckpt, device=CPU)
    assert log_tick == int(eng.state.tick) == 4
    _assert_states_equal(eng, restored)       # dtypes and bytes
    man = ckpt.manifest()
    assert man["meta"] == {"log_tick": 4, "engine": "rt", "layout": layout}
    assert "plan" not in man["meta"]
    assert _blob(ckpt, 4).startswith(b"FHC1")     # a zlib codec container
    assert set(ckpt.last_save_ms) >= {"to_host", "diff", "savez", "zlib",
                                      "raw_sha256", "sha256", "write_fsync"}
    assert set(ckpt.last_restore_ms) >= {"read", "sha256", "zlib",
                                         "raw_sha256", "npz_load",
                                         "delta_apply", "to_device"}


def test_snapshot_restore_refuses_the_other_layout(tmp_path):
    eng = _engine(_cfg(cooc_layout="region"))
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    eng.save_snapshot(ckpt)
    FirehoseLogWriter(str(tmp_path / "log")).close()
    with pytest.raises(ValueError, match="cooc_layout"):
        _recover(_cfg(cooc_layout="hash"), ckpt, str(tmp_path / "log"))
    with pytest.raises(ValueError, match="leaves"):
        SearchAssistanceEngine.restore_from_snapshot(
            _cfg(cooc_layout="hash"), ckpt, device=CPU)


def test_delta_shadow_owns_its_bytes_on_the_cpu(tmp_path):
    """On the CPU ``state_arrays()`` aliases the live tensors, which the
    stores then mutate in place. The manager's shadow must be its own copy:
    a delta after more steps is non-empty, and restoring it gives the live
    state."""
    cfg = _cfg("sweep", rank_every=0)
    eng = _engine(cfg)
    batches = _batches(6, seed=5)
    for ev, tw in batches[:3]:
        eng.step(ev, tw)
    aliased = eng.state_arrays()["leaf_4"]        # qstore weight, a view
    ckpt = CheckpointManager(str(tmp_path), keep_n=0, full_interval=4)
    eng.save_snapshot(ckpt)
    before = aliased.copy()
    for ev, tw in batches[3:]:
        eng.step(ev, tw)
    assert not np.array_equal(aliased, before), "the test needs aliasing"
    eng.save_snapshot(ckpt)
    assert ckpt.last_save_kind == "delta"
    assert decode_payload(_blob(ckpt, 6))[0]["leaf_4_idx"].size > 0
    restored, _ = SearchAssistanceEngine.restore_from_snapshot(
        cfg, ckpt, device=CPU)
    _assert_states_equal(eng, restored)


def _blob(ckpt, step):
    """A step's arrays.npz bytes as written."""
    with open(os.path.join(ckpt._step_dir(step), "arrays.npz"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.uint16,
                                   torch.uint64])
def test_unstorable_leaves_are_refused(tmp_path, dtype):
    ckpt = CheckpointManager(str(tmp_path))
    with pytest.raises(ValueError, match="cannot snapshot"):
        ckpt.save(1, [torch.zeros(16).to(dtype), torch.arange(4)])
    assert ckpt.steps() == []


def test_raw_viewed_snapshot_is_refused(tmp_path):
    """A manifest recording raw-viewed leaves (the JAX package writes one
    for bfloat16) is refused on restore, not read as its raw view."""
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, [torch.zeros(16, dtype=torch.int16)])
    path = os.path.join(ckpt._step_dir(1), "MANIFEST.json")
    with open(path) as f:
        man = json.load(f)
    man["raw_dtypes"] = {"leaf_0": "bfloat16"}
    with open(path, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="raw-viewed"):
        ckpt.restore([torch.zeros(16, dtype=torch.int16)])


# ---------------------------------------------------------------------------
# Multi-tick ingest == live stepping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["sweep", "lazy"])
def test_ingest_many_matches_step_loop(policy):
    cfg = _cfg(policy, decay_every=3, prune_every=5)
    batches = _batches(8)
    a = _engine(cfg)
    for ev, tw in batches:
        a.step(ev, tw)
    b = _engine(cfg)
    b.step_many(_stack(batches))
    _assert_states_equal(a, b)
    assert (a.n_prune_cycles, a.n_decay_cycles) == \
        (b.n_prune_cycles, b.n_decay_cycles)
    a.run_rank_cycle()
    b.run_rank_cycle()
    assert a.suggestions == b.suggestions


def test_ingest_many_queries_only():
    """A log without a firehose (query-only stack) replays the query path."""
    cfg = _cfg(rank_every=0)
    batches = _batches(4, tweets=0)
    a = _engine(cfg)
    for ev, _ in batches:
        a.step(ev, None)
    b = _engine(cfg)
    b.state = ingest_many(b.state, _stack(batches, queries_only=True),
                          cfg=cfg)
    _assert_states_equal(a, b)


def test_chunk_to_stack_defaults_to_cuda(monkeypatch, tmp_path):
    w = FirehoseLogWriter(str(tmp_path), ticks_per_segment=2)
    for t, (ev, tw) in enumerate(_batches(2)):
        w.append(t, ev, tw)
    chunk = next(FirehoseLogReader(str(tmp_path)).read_chunks(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chunk_to_stack(chunk)
    assert chunk_to_stack(chunk, "cpu").q_hi.device.type == "cpu"


# ---------------------------------------------------------------------------
# Crash -> restore -> replay == uninterrupted run (the §4.2 property)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["hash", "region"])
@pytest.mark.parametrize("policy", ["sweep", "lazy"])
def test_crash_at_every_segment_boundary(policy, layout):
    """Crash after every sealed segment: recovery (a delta chain, 3-tick
    segments, 4-tick replay chunks) reproduces the uninterrupted run bit
    for bit, and so do its suggestions."""
    n_ticks, tps = 12, 3
    cfg = _cfg(policy, cooc_layout=layout)
    batches = _batches(n_ticks, seed=17)
    with tempfile.TemporaryDirectory() as tmp:
        logd, ckd = os.path.join(tmp, "log"), os.path.join(tmp, "ck")
        ckpt = CheckpointManager(ckd, keep_n=10, full_interval=2)
        w = FirehoseLogWriter(logd, ticks_per_segment=tps)
        live = _engine(cfg)
        states_at = {}
        for t, (ev, tw) in enumerate(batches):
            w.append(t, ev, tw)
            if live.step(ev, tw) is not None:
                live.save_snapshot(ckpt)
            states_at[t + 1] = _copy_arrays(live)
        w.close()
        assert {ckpt.manifest(s)["kind"] for s in ckpt.steps()} == \
            {"full", "delta"}
        n_checked = 0
        for boundary in range(tps, n_ticks + 1, tps):
            steps = [s for s in ckpt.steps() if s <= boundary]
            if not steps:
                continue
            eng, stats = _recover(cfg, ckpt, logd, ReplayConfig(chunk_ticks=4),
                                  target_tick=boundary, step=steps[-1])
            assert int(eng.state.tick) == boundary
            _assert_states_equal(states_at[boundary], eng)
            ref = _engine(cfg)
            ref.load_state_arrays(states_at[boundary])
            ref.run_rank_cycle()
            eng.run_rank_cycle()
            assert ref.suggestions == eng.suggestions and eng.suggestions
            n_checked += 1
        assert n_checked >= 3


def test_replay_rank_suppression_and_handoff(tmp_path):
    cfg = _cfg(rank_every=2)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    w = FirehoseLogWriter(str(tmp_path / "log"), ticks_per_segment=5)
    _engine(cfg).save_snapshot(ckpt)    # snapshot at tick 0: replay all
    for t, (ev, tw) in enumerate(_batches(10)):
        w.append(t, ev, tw)
    w.close()
    eng, stats = _recover(cfg, ckpt, str(tmp_path / "log"),
                          ReplayConfig(chunk_ticks=4, rank_lag_ticks=3))
    assert stats["n_ticks"] == 10
    # rank boundaries 2, 4, 6, 8: the lagging chunks suppress theirs, the
    # near-head chunks run one each, fresh tables are left at handoff
    assert stats["n_rank_suppressed"] == 2
    assert stats["n_rank_run"] == 2
    assert eng.suggestions
    assert eng.last_rank_tick == int(eng.state.tick)


def test_replay_gap_detection(tmp_path):
    cfg = _cfg(rank_every=0)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    _engine(cfg).save_snapshot(ckpt)   # offset 0
    w = FirehoseLogWriter(str(tmp_path / "log"), ticks_per_segment=2,
                          keep_segments=2)            # retention drops 0..3
    for t, (ev, tw) in enumerate(_batches(8)):
        w.append(t, ev, tw)
    with pytest.raises(ValueError, match="retention"):
        _recover(cfg, ckpt, str(tmp_path / "log"))
    eng, stats = _recover(cfg, ckpt, str(tmp_path / "log"),
                          ReplayConfig(allow_gap=True))
    assert stats["n_skipped_gap_ticks"] == 4
    assert int(eng.state.tick) == 8


def test_replay_mid_log_gap(tmp_path):
    cfg = _cfg(rank_every=0)
    batches = _batches(8)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    _engine(cfg).save_snapshot(ckpt)   # offset 0
    w = FirehoseLogWriter(str(tmp_path / "log"), ticks_per_segment=2)
    for t in (0, 1, 2, 3):
        w.append(t, *batches[t])
    w.close()
    w2 = FirehoseLogWriter(str(tmp_path / "log"), ticks_per_segment=2)
    for t in (6, 7):                      # ticks 4, 5 died with the crash
        w2.append(t, *batches[t])
    w2.close()
    with pytest.raises(ValueError, match="log gap"):
        _recover(cfg, ckpt, str(tmp_path / "log"))
    eng, stats = _recover(cfg, ckpt, str(tmp_path / "log"),
                          ReplayConfig(chunk_ticks=4, allow_gap=True))
    assert stats["n_skipped_gap_ticks"] == 2
    assert stats["n_ticks"] == 6
    assert int(eng.state.tick) == 8


def test_replay_intra_segment_hole(tmp_path):
    cfg = _cfg(rank_every=0)
    batches = _batches(7)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    _engine(cfg).save_snapshot(ckpt)   # offset 0
    w = FirehoseLogWriter(str(tmp_path / "log"), ticks_per_segment=8)
    for t in (0, 1, 2, 5, 6):                         # ticks 3, 4 missing
        w.append(t, *batches[t])
    w.close()                                          # one segment
    with pytest.raises(ValueError, match="allow_gap"):
        _recover(cfg, ckpt, str(tmp_path / "log"))
    eng, stats = _recover(cfg, ckpt, str(tmp_path / "log"),
                          ReplayConfig(chunk_ticks=8, allow_gap=True))
    assert stats["n_skipped_gap_ticks"] == 2
    assert stats["n_ticks"] == 5
    assert int(eng.state.tick) == 7


def test_replay_refuses_a_log_with_compaction_bases(tmp_path):
    """Log compaction is not ported: a log advertising a base is refused,
    not replayed without it."""
    cfg = _cfg(rank_every=0)
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    _engine(cfg).save_snapshot(ckpt)
    logd = str(tmp_path / "log")
    w = FirehoseLogWriter(logd, ticks_per_segment=2)
    for t, (ev, tw) in enumerate(_batches(4)):
        w.append(t, ev, tw)
    man = os.path.join(logd, "firehose-MANIFEST.json")
    with open(man) as f:
        doc = json.load(f)
    doc["bases"] = [{"tick": 2, "epoch": 0, "engines": {"rt": 2}}]
    with open(man, "w") as f:
        json.dump(doc, f)
    with pytest.raises(NotImplementedError, match="compaction"):
        _recover(cfg, ckpt, logd)


# ---------------------------------------------------------------------------
# Leader-gated, epoch-fenced log writer
# ---------------------------------------------------------------------------

def test_leader_gated_log_append(tmp_path):
    batches = _batches(3)
    group = ReplicaGroup(3, CheckpointManager(str(tmp_path / "ck")))
    w = FirehoseLogWriter(str(tmp_path / "log"), ticks_per_segment=1)
    assert group.log_append(0, w, 0, *batches[0])
    assert not group.log_append(1, w, 1, *batches[1])   # non-leader dropped
    group.fail(0)
    assert group.epoch == 1
    assert group.log_append(1, w, 1, *batches[1])       # failover continues
    r = FirehoseLogReader(str(tmp_path / "log"))
    assert (r.first_tick(), r.last_tick()) == (0, 1)


def test_stale_standby_writer_failover_and_fencing(tmp_path):
    """A standby's writer built before the old leader's seals re-syncs at
    segment start; once it assumes a newer epoch, the old leader's writer
    is fenced and writes nothing."""
    batches = _batches(4)
    w_leader = FirehoseLogWriter(str(tmp_path), ticks_per_segment=1)
    w_standby = FirehoseLogWriter(str(tmp_path), ticks_per_segment=1)
    w_leader.append(0, *batches[0])
    w_leader.append(1, *batches[1])
    with pytest.raises(ValueError, match="non-monotonic"):
        w_standby.append(1, *batches[1])
    w_standby.assume_epoch(1)
    assert log_epoch(str(tmp_path)) == 1
    w_standby.append(2, *batches[2])
    with pytest.raises(WriterFencedError):
        w_leader.append(3, *batches[3])
    r = FirehoseLogReader(str(tmp_path))
    assert [(s.first, s.last) for s in r.segments] == [(0, 0), (1, 1), (2, 2)]


# ---------------------------------------------------------------------------
# Delta snapshot chains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["hash", "region"])
def test_delta_chain_restore_equals_full(tmp_path, layout):
    """Delta-chain restore == full restore bit for bit at every step (the
    region directory, fills and owners ride the deltas), deltas smaller."""
    cfg = _cfg("lazy", cooc_layout=layout)
    eng = _engine(cfg)
    ck_full = CheckpointManager(str(tmp_path / "full"), keep_n=0)
    ck_delta = CheckpointManager(str(tmp_path / "delta"), keep_n=0,
                                 full_interval=3)
    full_bytes, delta_bytes = [], []
    for ev, tw in _batches(8, seed=3):
        eng.step(ev, tw)
        eng.save_snapshot(ck_full)
        full_bytes.append(ck_full.last_save_bytes)
        eng.save_snapshot(ck_delta)
        if ck_delta.last_save_kind == "delta":
            delta_bytes.append(ck_delta.last_save_bytes)
    assert len(delta_bytes) >= 4, "the chain must hold deltas"
    for step in ck_full.steps():
        a, _ = SearchAssistanceEngine.restore_from_snapshot(
            cfg, ck_full, step, device=CPU)
        b, _ = SearchAssistanceEngine.restore_from_snapshot(
            cfg, ck_delta, step, device=CPU)
        assert ck_delta.last_restore["restored"] == step
        _assert_states_equal(a, b)
    _assert_states_equal(eng, b)
    assert max(delta_bytes) < min(full_bytes)


def test_corrupt_delta_mid_chain_falls_back(tmp_path):
    cfg = _cfg("lazy")
    logd = str(tmp_path / "log")
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep_n=0, full_interval=4)
    w = FirehoseLogWriter(logd, ticks_per_segment=3)
    live = _engine(cfg)
    for t, (ev, tw) in enumerate(_batches(12, seed=7)):
        w.append(t, ev, tw)
        live.step(ev, tw)
        if (t + 1) % 2 == 0:
            live.save_snapshot(ckpt)   # steps 2f 4d 6d 8d 10f 12d
    w.close()
    kinds = {s: ckpt.manifest(s)["kind"] for s in ckpt.steps()}
    assert kinds == {2: "full", 4: "delta", 6: "delta", 8: "delta",
                     10: "full", 12: "delta"}
    eng, stats = _recover(cfg, ckpt, logd)
    assert not stats["restore"]["fell_back"]
    _assert_states_equal(live, eng)
    corrupt_snapshot(ckpt, 6)
    eng, stats = _recover(cfg, ckpt, logd, step=8)
    assert stats["restore"] == {"requested": 8, "restored": 2,
                                "chain_len": 1, "fell_back": True}
    assert stats["n_ticks"] == 10
    _assert_states_equal(live, eng)
    corrupt_snapshot(ckpt, 10)
    eng, stats = _recover(cfg, ckpt, logd)
    assert stats["restore"]["fell_back"] and \
        stats["restore"]["restored"] == 2
    _assert_states_equal(live, eng)
    corrupt_snapshot(ckpt, 2)
    with pytest.raises(FileNotFoundError, match="intact full"):
        _recover(cfg, ckpt, logd)


def test_delta_retention_never_strands(tmp_path):
    cfg = _cfg("lazy", rank_every=0)
    eng = _engine(cfg)
    ckpt = CheckpointManager(str(tmp_path), keep_n=2, full_interval=3)
    for ev, tw in _batches(8, seed=9):
        eng.step(ev, tw)
        eng.save_snapshot(ckpt)
        for s in ckpt.steps():
            cur, hops = s, 0
            while True:
                man = ckpt.manifest(cur)   # raises if stranded
                if man["kind"] == "full":
                    break
                cur = man["base_step"]
                hops += 1
                assert hops <= ckpt.full_interval
            restored, got = SearchAssistanceEngine.restore_from_snapshot(
                cfg, ckpt, s, device=CPU)
            assert got == s and not ckpt.last_restore["fell_back"]
        _assert_states_equal(eng, restored)
    # kinds ran 1f 2d 3d 4f 5d 6d 7f 8d: keep_n=2 keeps {7, 8}
    assert set(ckpt.steps()) == {7, 8}
    assert ckpt.manifest(8)["base_step"] == 7
    assert ckpt.manifest(7)["kind"] == "full"


def test_torn_manifest_falls_back(tmp_path):
    cfg = _cfg("lazy")
    logd = str(tmp_path / "log")
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep_n=0, full_interval=3)
    w = FirehoseLogWriter(logd, ticks_per_segment=3)
    live = _engine(cfg)
    for t, (ev, tw) in enumerate(_batches(6, seed=13)):
        w.append(t, ev, tw)
        live.step(ev, tw)
        if (t + 1) % 2 == 0:
            live.save_snapshot(ckpt)    # steps 2f 4d 6d
    w.close()
    with open(os.path.join(ckpt._step_dir(6), "MANIFEST.json"), "w") as f:
        f.write('{"step": 6, "kind"')   # torn mid-write
    eng, stats = _recover(cfg, ckpt, logd)
    assert stats["restore"]["fell_back"]
    assert stats["restore"]["restored"] == 2
    _assert_states_equal(live, eng)


def test_delta_shape_change_forces_full(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), full_interval=4)
    ckpt.save(1, {"x": torch.arange(8, dtype=torch.float32)})
    ckpt.save(2, {"x": torch.arange(8, dtype=torch.float32) * 2})
    assert ckpt.last_save_kind == "delta"
    ckpt.save(3, {"x": torch.arange(16, dtype=torch.float32)})
    assert ckpt.last_save_kind == "full"
    restored, _ = ckpt.restore({"x": torch.zeros(16)}, 3)
    np.testing.assert_array_equal(restored["x"].numpy(), np.arange(16))
    ckpt2 = CheckpointManager(str(tmp_path), full_interval=4)
    ckpt2.save(4, {"x": torch.arange(16, dtype=torch.float32)})
    assert ckpt2.last_save_kind == "full"


def test_recovery_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """restore_from_snapshot, recover_engine and breaking_news.run run on
    CUDA unless given a device, and raise where it is absent."""
    from repro_torch import breaking_news
    cfg = _cfg()
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    _engine(cfg).save_snapshot(ckpt)
    FirehoseLogWriter(str(tmp_path / "log")).close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchAssistanceEngine.restore_from_snapshot(cfg, ckpt)
    with pytest.raises(RuntimeError, match="CUDA"):
        recover_engine(cfg, ckpt, str(tmp_path / "log"))
    with pytest.raises(RuntimeError, match="CUDA"):
        breaking_news.run(out_dir=str(tmp_path / "news"), log=lambda s: None)
    eng, stats = _recover(cfg, ckpt, str(tmp_path / "log"))
    assert eng.device.type == "cpu" and stats["n_ticks"] == 0

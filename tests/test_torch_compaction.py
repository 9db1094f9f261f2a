"""The PyTorch port's log compaction, on the CPU.

Against the JAX package: on one log the JAX writer wrote, the port's
``LogCompactor`` and JAX's each fold two bases (the second dropping
segments); the bases are equal leaf for leaf (under the parity contract of
``torch_parity.py``; ints exact) and the manifests equal (segments kept and
dropped, ``bases`` entries but their wall time); a JAX base restores into
the port through ``restore_from_base`` and a port base into JAX, bit for
bit.

The port against itself (the cases of ``tests/test_compaction.py``): the
fold bit-exact at every compaction boundary (both layouts) with the early
segments gone from disk, ``recover_service`` from bases after the trim, a
corrupt base falling back (counted), a crash before the swap invisible,
debris after the swap repairable, a zombie compactor fenced, the writer's
retention guard, the injectors composed with the compactor, a log hole
refused by the fold; and
``serve_assist.run`` with compaction, whose segments on disk stay bounded
and which recovers bit for bit. No test reads a wall clock.
"""
import dataclasses
import json
import os
import shutil
import time

import pytest
import torch

from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SearchAssistanceEngine as JEngine
from repro.core.decay import DecayConfig as JDecayConfig
from repro.streaming import FirehoseLogWriter as JLogWriter
from repro.streaming import LogCompactor as JLogCompactor
from repro.streaming import CompactionConfig as JCompactionConfig
from repro.streaming import restore_from_base as jrestore_from_base
from repro_torch.core.background import AssistanceService
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.data.stream import StreamConfig, SyntheticStream
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.launch import serve_assist
from repro_torch.streaming import (CatchUpController, CompactionConfig,
                                   FirehoseLogReader, FirehoseLogWriter,
                                   LogCompactor, ReplayConfig,
                                   WriterFencedError, corrupt_base,
                                   flaky_io, log_bases, recover_engine,
                                   recover_service, restore_from_base,
                                   slow_io)
from repro_torch.streaming.compaction import base_manager
from torch_parity import compare_states

CPU = torch.device("cpu")
CFG = dict(query_capacity=1 << 11, cooc_capacity=1 << 13,
           session_capacity=1 << 10, session_window=3, decay_every=4,
           prune_every=6, rank_every=5, region_width=16)
STREAM = StreamConfig(vocab_size=256, n_users=120, queries_per_tick=96,
                      tweets_per_tick=8, tweet_words=3, tweet_grams=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread under the tier-1 run's worker processes,
    restored after the module (results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(policy="lazy", **kw):
    return EngineConfig(**{**CFG, **kw}, decay=DecayConfig(policy=policy))


def _bg_cfg(cfg: EngineConfig) -> EngineConfig:
    slow = dataclasses.replace(cfg.decay,
                               half_life_ticks=cfg.decay.half_life_ticks * 8,
                               prune_threshold=cfg.decay.prune_threshold * 0.5)
    return dataclasses.replace(cfg, decay=slow, rank_every=7,
                               decay_every=6, prune_every=9)


def _batches(n, seed=11):
    stream = SyntheticStream(STREAM, seed=seed)
    return [stream.gen_tick(t) for t in range(n)]


def _engine(cfg):
    return SearchAssistanceEngine(cfg, "rt", device=CPU)


def _arrays(state, cfg):
    e = _engine(cfg)
    e.state = state
    return e.state_arrays()


def _bits_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _write_log(tmp_path, batches, ticks_per_segment=3, **kw):
    logd = str(tmp_path / "log")
    w = FirehoseLogWriter(logd, ticks_per_segment=ticks_per_segment, **kw)
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
    w.close()
    return logd


def _compactor(logd, engines, keep_bases=2, **kw):
    return LogCompactor(logd, engines, device=CPU,
                        cfg=CompactionConfig(keep_bases=keep_bases,
                                             chunk_ticks=4), **kw)


# ---------------------------------------------------------------------------
# Against JAX: the same bases, manifests, and cross-loads
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_and_port_bases(tmp_path_factory):
    """A JAX-written log (12 ticks, 3 a segment), copied; JAX's compactor
    folds one copy and the port's the other, to floors 6 and 9 under
    ``keep_bases=1`` (the second fold drops the segments below 9)."""
    root = tmp_path_factory.mktemp("compaction_parity")
    cfg = dict(CFG, rank_every=0)
    jcfg = JEngineConfig(**cfg, decay=JDecayConfig(policy="sweep"))
    tcfg = EngineConfig(**cfg, decay=DecayConfig(policy="sweep"))
    w = JLogWriter(str(root / "jax"), ticks_per_segment=3)
    for t, (ev, tw) in enumerate(_batches(12, seed=5)):
        w.append(t, ev, tw)
    w.close()
    shutil.copytree(root / "jax", root / "port")
    jc = JLogCompactor(str(root / "jax"), {"rt": jcfg},
                       cfg=JCompactionConfig(keep_bases=1, chunk_ticks=4))
    tc = LogCompactor(str(root / "port"), {"rt": tcfg}, device=CPU,
                      cfg=CompactionConfig(keep_bases=1, chunk_ticks=4))
    stats = {}
    for upto in (6, 9):
        stats[upto] = (jc.compact(upto_tick=upto), tc.compact(upto_tick=upto))
    return root, jcfg, tcfg, stats


def _manifest(d):
    with open(os.path.join(d, "firehose-MANIFEST.json")) as f:
        doc = json.load(f)
    for b in doc["bases"]:
        b.pop("time")
    return doc


def test_port_bases_match_jax(jax_and_port_bases):
    root, jcfg, tcfg, stats = jax_and_port_bases
    for upto, (js, ts) in stats.items():
        for key in ("noop", "floor", "prev_floor", "retain_floor",
                    "n_bases", "n_segments_dropped", "n_unlinked"):
            assert ts[key] == js[key], (upto, key)
        for key in ("start", "n_ticks", "fell_back", "base_bytes"):
            assert ts["engines"]["rt"][key] == js["engines"]["rt"][key], key
    assert [stats[u][1]["n_segments_dropped"] for u in (6, 9)] == [2, 1]
    assert _manifest(root / "port") == _manifest(root / "jax")
    assert sorted(os.listdir(root / "port")) == sorted(os.listdir(root / "jax"))
    jb = CheckpointManager(str(root / "jax" / "firehose-compact" / "rt"))
    tb = CheckpointManager(str(root / "port" / "firehose-compact" / "rt"))
    assert jb.steps() == tb.steps() == [9]
    assert tb.manifest()["meta"] == jb.manifest()["meta"]
    assert compare_states(jb.load_arrays()[0], tb.load_arrays()[0],
                          tcfg.decay.prune_threshold) == 0


def test_jax_base_restores_into_port(jax_and_port_bases):
    root, jcfg, tcfg, _ = jax_and_port_bases
    state, tick, info = restore_from_base(str(root / "jax"), "rt",
                                          _engine(tcfg).state)
    jstate, jtick, jinfo = jrestore_from_base(str(root / "jax"), "rt",
                                              JEngine(jcfg).state)
    assert (tick, info) == (jtick, jinfo) == (9, {"requested": 9,
                                                  "restored": 9,
                                                  "fell_back": False})
    j = JEngine(jcfg)
    j.state = jstate
    _bits_equal(_arrays(state, tcfg), j.state_arrays())


def test_port_base_restores_into_jax(jax_and_port_bases):
    root, jcfg, tcfg, _ = jax_and_port_bases
    jstate, jtick, _ = jrestore_from_base(str(root / "port"), "rt",
                                          JEngine(jcfg).state)
    state, tick, _ = restore_from_base(str(root / "port"), "rt",
                                       _engine(tcfg).state)
    assert jtick == tick == 9
    j = JEngine(jcfg)
    j.state = jstate
    _bits_equal(j.state_arrays(), _arrays(state, tcfg))


MAX_TICKS = [None, -1, 0, 5, 6, 7, 8, 9, 10, 11, 50]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_newest_base_matches_jax(jax_and_port_bases, writer):
    """``FirehoseLogReader.newest_base`` on a log either compactor folded,
    read by both packages' readers."""
    from repro.streaming import FirehoseLogReader as JLogReader
    root = jax_and_port_bases[0]
    t, j = FirehoseLogReader(str(root / writer)), JLogReader(str(root / writer))
    assert t.bases and t.bases == j.bases
    for mt in MAX_TICKS:
        assert t.newest_base(mt) == j.newest_base(mt), mt
    assert t.newest_base()["tick"] == t.floor_tick() == 9


def test_newest_base_over_several_bases_matches_jax(tmp_path):
    """Three bases kept: each ``max_tick`` picks the newest base at or
    below it, as JAX's reader does on the same directory."""
    from repro.streaming import FirehoseLogReader as JLogReader
    cfg = _cfg("sweep", rank_every=0)
    logd = _write_log(tmp_path, _batches(13))
    comp = _compactor(logd, {"rt": cfg}, keep_bases=3)
    for upto in (3, 6, 9):
        comp.compact(upto_tick=upto)
    t, j = FirehoseLogReader(logd), JLogReader(logd)
    assert [int(b["tick"]) for b in t.bases] == [3, 6, 9]
    picked = []
    for mt in MAX_TICKS + [2, 3, 4]:
        got = t.newest_base(mt)
        assert got == j.newest_base(mt), mt
        picked.append(None if got is None else int(got["tick"]))
    assert picked[:5] == [9, None, None, 3, 6]


# ---------------------------------------------------------------------------
# The fold is bit-exact at every boundary; disk stays bounded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["hash", "region"])
def test_compaction_bit_exact_at_every_boundary(tmp_path, layout):
    """For EVERY segment-aligned floor: fold -> restore_from_base is
    bit-for-bit the uninterrupted engine at that tick, and the final
    replay-from-'zero' (base + tail) matches the live head state even
    though the early segments are gone from disk."""
    kw = dict(cooc_layout=layout, region_chain=8) if layout == "region" else {}
    cfg = _cfg(**kw)
    n = 18
    batches = _batches(n)
    logd = str(tmp_path / "log")
    w = FirehoseLogWriter(logd, ticks_per_segment=3)
    live = _engine(cfg)
    ref = {}
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
        live.step(ev, tw)
        if (t + 1) % 3 == 0:
            ref[t + 1] = live.state_arrays()     # host copies
    w.close()

    comp = _compactor(logd, {"rt": cfg})
    template = _engine(cfg).state
    for b in range(3, n + 1, 3):
        stats = comp.compact(upto_tick=b)
        assert not stats["noop"] and stats["floor"] == b
        assert stats["engines"]["rt"]["start"] == b - 3
        state, tick, info = restore_from_base(logd, "rt", template)
        assert tick == b and not info["fell_back"]
        _bits_equal(_arrays(state, cfg), ref[b])
    assert comp.n_compactions == n // 3

    r = FirehoseLogReader(logd)
    assert r.floor_tick() == n
    assert [int(b["tick"]) for b in r.bases] == [n - 3, n]
    assert r.first_tick() == n - 3
    assert all(s.first >= n - 3 for s in r.segments)
    on_disk = [f for f in os.listdir(logd) if f.endswith(".npz")]
    assert len(on_disk) == len(r.segments)

    cold = _engine(cfg)
    state, tick, _ = restore_from_base(logd, "rt", cold.state)
    cold.state = state
    CatchUpController(cold, r, ReplayConfig(chunk_ticks=4)).catch_up()
    _bits_equal(cold.state_arrays(), live.state_arrays())


def test_recover_service_replays_from_base_after_trim(tmp_path):
    """Whole-stack cold recovery (no snapshots at all) over a log whose
    tail below the floor was trimmed: both engines hop onto their bases
    and the recovered stack is bit-exact vs an uninterrupted service."""
    cfg = _cfg()
    bg = _bg_cfg(cfg)
    n = 20
    batches = _batches(n)
    logd = str(tmp_path / "log")
    w = FirehoseLogWriter(logd, ticks_per_segment=4)
    ref = AssistanceService(cfg, bg_cfg=bg, device=CPU)
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
        ref.step(ev, tw)
    w.close()
    comp = _compactor(logd, {"rt": cfg, "bg": bg})
    comp.compact(upto_tick=8)
    comp.compact(upto_tick=16)
    r = FirehoseLogReader(logd)
    assert r.first_tick() == 8 and r.floor_tick() == 16

    # a cold catch-up that ignored the bases would hit the trimmed gap
    bare = _engine(cfg)
    with pytest.raises(ValueError, match="predates log retention"):
        CatchUpController(bare, r, ReplayConfig(chunk_ticks=4)).catch_up()

    svc, stats = recover_service(
        cfg, CheckpointManager(str(tmp_path / "rt")),
        CheckpointManager(str(tmp_path / "bg")), logd,
        ReplayConfig(chunk_ticks=4), bg_cfg=bg, device=CPU)
    for part in ("rt", "bg"):
        assert stats[part]["base"]["base_tick"] == 16
        assert not stats[part]["base"]["fell_back"]
        assert stats[part]["n_ticks"] == n - 16
    _bits_equal(svc.rt.state_arrays(), ref.rt.state_arrays())
    _bits_equal(svc.bg.state_arrays(), ref.bg.state_arrays())


def test_snapshot_newer_than_the_base_wins(tmp_path):
    """An engine whose own snapshot is newer than every base replays from
    the snapshot (``stats['base']`` None); an older one hops onto the
    base. Both end bit for bit the uninterrupted engine."""
    cfg = _cfg(rank_every=0)
    batches = _batches(14)
    logd = str(tmp_path / "log")
    w = FirehoseLogWriter(logd, ticks_per_segment=3)
    live = _engine(cfg)
    ck = CheckpointManager(str(tmp_path / "ck"), keep_n=0)
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
        live.step(ev, tw)
        if t in (4, 10):
            live.save_snapshot(ck)              # steps 5 and 11
    w.close()
    _compactor(logd, {"rt": cfg}).compact(upto_tick=9)
    for step, base, replayed in ((11, None, 3), (5, 9, 5)):
        eng, stats = recover_engine(cfg, ck, logd,
                                    ReplayConfig(chunk_ticks=4), step=step,
                                    device=CPU)
        assert (stats["base"] or {}).get("base_tick") == base
        assert stats["n_ticks"] == replayed
        _bits_equal(eng.state_arrays(), live.state_arrays())


def test_corrupt_base_falls_back_to_previous_and_is_counted(tmp_path):
    """A torn newest base degrades to the previous base + a longer replay
    — exact, and counted on both the restore and the next fold."""
    cfg = _cfg()
    n = 18
    batches = _batches(n)
    live = _engine(cfg)
    logd = str(tmp_path / "log")
    w = FirehoseLogWriter(logd, ticks_per_segment=3)
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
        live.step(ev, tw)
    w.close()
    comp = _compactor(logd, {"rt": cfg})
    comp.compact(upto_tick=6)
    comp.compact(upto_tick=12)
    assert [int(b["tick"]) for b in log_bases(logd)] == [6, 12]

    step = corrupt_base(logd, "rt")          # tears the newest (tick 12)
    assert step == 12
    eng = _engine(cfg)
    state, tick, info = restore_from_base(logd, "rt", eng.state)
    assert tick == 6 and info["fell_back"] and info["requested"] == 12
    eng.state = state
    CatchUpController(eng, FirehoseLogReader(logd),
                      ReplayConfig(chunk_ticks=4)).catch_up()
    _bits_equal(eng.state_arrays(), live.state_arrays())

    # the next fold starts from the older intact base and counts it too
    assert comp.n_base_fallbacks == 0
    stats = comp.compact(upto_tick=18)
    assert stats["engines"]["rt"]["fell_back"]
    assert stats["engines"]["rt"]["start"] == 6
    assert comp.n_base_fallbacks == 1
    _, tick, info = restore_from_base(logd, "rt", eng.state)
    assert tick == 18 and not info["fell_back"]


# ---------------------------------------------------------------------------
# Crash safety + fencing of the compaction cycle
# ---------------------------------------------------------------------------

def test_compaction_crash_before_swap_is_invisible(tmp_path):
    """Crash after the fold but before the manifest swap: the floor does
    not move, the orphan base snapshot is never advertised, and the retried
    compaction lands cleanly on the same floor."""
    cfg = _cfg()
    logd = _write_log(tmp_path, _batches(9))
    comp = _compactor(logd, {"rt": cfg})
    orig = comp._check_fence
    calls = {"n": 0}

    def crashy():
        doc = orig()
        calls["n"] += 1
        if calls["n"] == 2:          # the re-validation right before the swap
            raise OSError("injected crash between fold and manifest swap")
        return doc

    comp._check_fence = crashy
    with pytest.raises(OSError):
        comp.compact(upto_tick=6)
    comp._check_fence = orig
    assert log_bases(logd) == []
    assert base_manager(logd, "rt").steps() == [6]
    assert restore_from_base(logd, "rt", _engine(cfg).state) is None
    stats = comp.compact(upto_tick=6)
    assert stats["floor"] == 6 and not stats["noop"]
    res = restore_from_base(logd, "rt", _engine(cfg).state)
    assert res is not None and res[1] == 6


def test_compaction_crash_after_swap_leaves_repairable_debris(tmp_path,
                                                             monkeypatch):
    """Crash after the manifest swap but before the old segments were
    unlinked: readers count the unmanifested files, ``repair()`` removes
    them, and replay-from-base is unaffected."""
    cfg = _cfg()
    logd = _write_log(tmp_path, _batches(12))
    comp = _compactor(logd, {"rt": cfg}, keep_bases=1)
    with monkeypatch.context() as m:
        def no_unlink(path):
            raise OSError("injected crash during old-segment unlink")
        m.setattr("repro_torch.streaming.compaction.os.unlink", no_unlink)
        stats = comp.compact(upto_tick=9)
    assert stats["floor"] == 9 and stats["n_segments_dropped"] == 3
    assert stats["n_unlinked"] == 0
    r = FirehoseLogReader(logd)
    assert r.first_tick() == 9
    assert r.n_unmanifested_files == 3
    assert r.repair() == 3
    r.refresh()
    assert r.n_unmanifested_files == 0
    res = restore_from_base(logd, "rt", _engine(cfg).state)
    assert res is not None and res[1] == 9


def test_zombie_compactor_is_fenced(tmp_path):
    """A deposed compactor can neither swap the manifest nor rewind the
    epoch; re-adopting the current epoch revives it."""
    cfg = _cfg()
    logd = _write_log(tmp_path, _batches(9), epoch=0)
    comp = _compactor(logd, {"rt": cfg}, epoch=0)
    assert not comp.compact(upto_tick=3)["noop"]
    bases_before = log_bases(logd)
    FirehoseLogWriter(logd, ticks_per_segment=3).assume_epoch(2)
    with pytest.raises(WriterFencedError):
        comp.compact(upto_tick=6)
    assert log_bases(logd) == bases_before
    with pytest.raises(WriterFencedError):
        comp.compact(upto_tick=6)
    with pytest.raises(WriterFencedError):
        comp.assume_epoch(1)
    stats = comp.assume_epoch(2).compact(upto_tick=6)
    assert stats["floor"] == 6
    assert [int(b["tick"]) for b in log_bases(logd)] == [3, 6]


def test_writer_retention_guard_warns_and_keeps_floor_segments(tmp_path):
    """Blunt keep-N retention must never trim a segment at/after the newest
    advertised base: it warns and clamps, and replay-from-base survives."""
    cfg = _cfg()
    batches = _batches(14)
    logd = _write_log(tmp_path, batches[:8], ticks_per_segment=2)
    comp = _compactor(logd, {"rt": cfg}, keep_bases=1)
    comp.compact(upto_tick=6)                 # floor 6; log tail = [(6,7)]
    w = FirehoseLogWriter(logd, ticks_per_segment=2, keep_segments=1)
    with pytest.warns(RuntimeWarning, match="compaction base"):
        for t in range(8, 12):
            w.append(t, *batches[t])
    w.close()
    r = FirehoseLogReader(logd)
    assert r.first_tick() == 6
    assert [(s.first, s.last) for s in r.segments] == [(6, 7), (8, 9),
                                                       (10, 11)]
    live = _engine(cfg)
    for ev, tw in batches[:12]:
        live.step(ev, tw)
    eng = _engine(cfg)
    state, tick, _ = restore_from_base(logd, "rt", eng.state)
    eng.state = state
    assert tick == 6
    CatchUpController(eng, r, ReplayConfig(chunk_ticks=4)).catch_up()
    _bits_equal(eng.state_arrays(), live.state_arrays())


def test_injectors_compose_with_compactor(tmp_path, monkeypatch):
    """The chaos injectors wrap the compaction cycle like any other I/O
    path: a transient fault surfaces once and lands nothing, the retry
    succeeds; a slowed compactor sleeps before it folds (the sleep is
    recorded, not timed)."""
    cfg = _cfg()
    logd = _write_log(tmp_path, _batches(6))
    comp = _compactor(logd, {"rt": cfg})
    flaky_io(comp, ("compact",), n_failures=1)
    with pytest.raises(OSError):
        comp.compact(upto_tick=3)
    assert log_bases(logd) == []
    assert comp.compact(upto_tick=3)["floor"] == 3
    comp._flaky_io_undo()
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    slow_io(comp, ("compact",), delay_s=0.05)
    assert comp.compact(upto_tick=6)["floor"] == 6
    assert slept == [0.05]
    comp._slow_io_undo()
    assert comp.compact(upto_tick=6)["noop"] and slept == [0.05]


def test_fold_refuses_a_log_hole(tmp_path):
    """A base must cover every tick below its floor: a log whose ticks
    6-8 never landed (a crash lost the writer's unsealed segment, the
    resumed run appended from its snapshot's tick 9) is refused by the
    fold, as the JAX package's fold refuses it, and the manifest keeps
    no base."""
    cfg = _cfg()
    batches = _batches(12)
    logd = str(tmp_path / "log")
    w = FirehoseLogWriter(logd, ticks_per_segment=3)
    for t, (ev, tw) in enumerate(batches):
        if not 6 <= t < 9:
            w.append(t, ev, tw)
    w.close()
    comp = _compactor(logd, {"rt": cfg})
    assert comp.compact(upto_tick=6)["floor"] == 6
    with pytest.raises(ValueError, match="fold gap"):
        comp.compact(upto_tick=12)
    assert [int(b["tick"]) for b in log_bases(logd)] == [6]


def test_compactor_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LogCompactor(str(tmp_path), {"rt": _cfg()})
    with pytest.raises(ValueError, match="engine"):
        LogCompactor(str(tmp_path), {}, device=CPU)


# ---------------------------------------------------------------------------
# serve_assist with compaction
# ---------------------------------------------------------------------------

ASSIST_CFG = EngineConfig(query_capacity=1 << 11, cooc_capacity=1 << 13,
                          session_capacity=1 << 10, decay_every=3,
                          rank_every=4)


def _assist(out, **kw):
    opts = serve_assist.AssistOptions(**{
        **dict(ticks=38, out=str(out), replicas=2, fail_replica_at=-1,
               crash_at=-1, recover=False, full_every=4, slow_io_ms=0.0,
               compact_every=8, keep_bases=2), **kw})
    return serve_assist.run(ASSIST_CFG, STREAM, opts, CPU,
                            log=lambda s: None)


def test_serve_assist_compaction_bounded_and_recovers(tmp_path):
    """Compaction every 8 ticks over 38: after each fold the log keeps only
    the segments from the oldest retained base on (at most 3 of 8 ticks
    on disk), both engines' bases are advertised, and a run crashed after
    the fold of tick 24 and resumed with ``recover`` ends bit for bit the
    uncrashed one, compacting again at 32; a cold recovery that ignores
    the state snapshots goes through the newest base."""
    ref = _assist(tmp_path / "ref")
    comps = ref["compactions"]
    assert [c["t"] for c in comps] == [8, 16, 24, 32]
    assert [c["stats"]["floor"] for c in comps] == [9, 17, 25, 33]
    # the first fold trims everything below its floor; from the second on
    # the older base keeps its 8-tick tail as the fallback
    assert [c["stats"]["n_segments_dropped"] for c in comps] == [2, 0, 1, 1]
    for c in comps[1:]:
        assert c["stats"]["retain_floor"] == c["stats"]["floor"] - 8
    for c in comps[2:]:
        assert c["bytes_after"]["segments"] < c["bytes_before"]["segments"]
        assert c["bytes_after"]["segments"] <= \
            1.1 * comps[1]["bytes_after"]["segments"]
    logd = str(tmp_path / "ref" / "log")
    r = FirehoseLogReader(logd)
    assert r.first_tick() >= 25 and len(r.segments) <= 3
    assert sorted(f for f in os.listdir(logd) if f.endswith(".npz")) == \
        sorted(s.file for s in r.segments)
    assert [sorted(b["engines"]) for b in r.bases] == [["bg", "rt"]] * 2

    crashed = _assist(tmp_path / "run", crash_at=24)
    assert crashed["crashed_at"] == 24
    res = _assist(tmp_path / "run", recover=True)
    assert res["recover"]["rt"]["restored_step"] == 25
    assert [c["stats"]["floor"] for c in res["compactions"]] == [33]
    for got, exp in zip(res["backends"] + [res["bg"]],
                        ref["backends"] + [ref["bg"]]):
        _bits_equal(got.state_arrays(), exp.state_arrays())
    assert res["final"] == ref["final"]

    cold, stats = recover_service(
        ASSIST_CFG, CheckpointManager(str(tmp_path / "empty_rt")),
        CheckpointManager(str(tmp_path / "empty_bg")), logd,
        ReplayConfig(chunk_ticks=8),
        bg_cfg=serve_assist.background_config(ASSIST_CFG, rank_every_mult=3),
        device=CPU)
    assert stats["rt"]["base"]["base_tick"] == \
        stats["bg"]["base"]["base_tick"] == 33
    _bits_equal(cold.rt.state_arrays(), ref["backends"][0].state_arrays())
    _bits_equal(cold.bg.state_arrays(), ref["bg"].state_arrays())

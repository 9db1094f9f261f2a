"""The PyTorch port's serving stack on the CPU, against itself.

``pack_suggestions`` round trips; ``recover_service`` restores the whole
rt + bg + interpolation stack bit for bit at every log-segment boundary
(both decay policies x both cooc layouts, delta-chained snapshots,
asymmetric snapshot offsets) and from no snapshot at all (the JAX
package's ``tests/test_recovery.py`` cases, held against the uninterrupted
port run); the ``serve_assist`` loop crashed mid-segment and at a sealed
segment, then resumed with ``--recover``, ends equal to the uninterrupted
run (engine states, state snapshots, persisted suggestion and spelling
tables), and its CLI runs on the CPU and takes the overload, workload and
compaction flags; its ``--fleet`` path, with the kill and compaction
flags, reports the JAX launcher's counters on the same command line.
Followers made after a recovery own their state: the port's stores
write in place, so replicas that shared one state would diverge (shown
here too).

Imports torch and ``repro_torch``; the ``--fleet`` test also runs the JAX
launcher.
"""
import dataclasses
import gc
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.background import (AssistanceService,
                                         background_config, interpolate)
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.data.stream import StreamConfig, SyntheticStream
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.launch import serve_assist
from repro_torch.serving.serve import (SuggestFrontend, pack_suggestions,
                                       unpack_suggestions)
from repro_torch.streaming import (FirehoseLogReader, FirehoseLogWriter,
                                   ReplayConfig, recover_service)

CPU = torch.device("cpu")
STREAM = StreamConfig(vocab_size=256, n_users=120, queries_per_tick=96,
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


def _cfg(policy="lazy", **kw):
    base = dict(query_capacity=1 << 11, cooc_capacity=1 << 13,
                session_capacity=1 << 10, session_window=3,
                decay_every=4, prune_every=6, rank_every=5,
                region_width=16, decay=DecayConfig(policy=policy))
    base.update(kw)
    return EngineConfig(**base)


def _bg_cfg(cfg: EngineConfig) -> EngineConfig:
    """A background config with cadences deliberately different from the
    rt engine's: replay must honour each engine's own cadence authority."""
    slow = dataclasses.replace(cfg.decay,
                               half_life_ticks=cfg.decay.half_life_ticks * 8,
                               prune_threshold=cfg.decay.prune_threshold * 0.5)
    return dataclasses.replace(cfg, decay=slow, rank_every=7,
                               decay_every=6, prune_every=9)


def _batches(n, seed=11):
    stream = SyntheticStream(STREAM, seed=seed)
    return [stream.gen_tick(t) for t in range(n)]


def _bits_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_pack_suggestions_round_trips():
    rng = np.random.default_rng(0)
    sugg = {int(s): [(int(d), float(x)) for d, x in zip(
        rng.integers(1, 2**64, 5, dtype=np.uint64), rng.random(5))][:n]
        for n, s in zip(range(1, 9),
                        rng.integers(1, 2**64, 8, dtype=np.uint64))}
    sugg[7] = []                      # a source with no rows survives too
    packed = pack_suggestions(sugg)
    assert {k: v.dtype for k, v in packed.items()} == {
        "src": np.uint64, "dst": np.uint64, "score": np.float64,
        "offsets": np.int64}
    assert unpack_suggestions(packed) == sugg
    assert list(unpack_suggestions(packed)) == list(sugg)
    assert unpack_suggestions(pack_suggestions({})) == {}


def test_interpolate_union_and_ties():
    rt = {1: [(10, 1.0), (11, 0.5)], 2: [(20, 0.2)]}
    bg = {1: [(11, 1.0), (12, 0.5 * 0.7 / 0.3)], 3: [(30, 1.0)], 4: []}
    out = interpolate(rt, bg, alpha=0.7, k=2)
    # union: 10 = 0.7, 11 = 0.35 + 0.3 = 0.65, 12 = 0.35; k=2 keeps 10, 11
    assert [d for d, _ in out[1]] == [10, 11]
    assert out[2] == [(20, pytest.approx(0.14))]
    assert out[3] == [(30, pytest.approx(0.3))]
    assert 4 not in out                  # no candidates, no row
    tie = interpolate({5: [(9, 1.0), (8, 1.0)]}, {}, alpha=1.0)
    assert tie[5] == [(8, 1.0), (9, 1.0)]   # (-score, dst)


def test_assistance_service_takes_a_config_or_both_engines():
    """A service is built from ``rt_cfg`` (both engines made here) or
    handed both engines (recovery); one engine alone is refused."""
    cfg = _cfg("sweep")
    svc = AssistanceService(cfg, device=CPU)
    assert svc.bg.cfg == background_config(cfg)
    same = AssistanceService(rt=svc.rt, bg=svc.bg)
    assert same.rt is svc.rt and same.bg is svc.bg
    for kw in ({}, {"rt": svc.rt}, {"bg": svc.bg},
               {"rt_cfg": cfg, "rt": svc.rt}):
        with pytest.raises(ValueError):
            AssistanceService(**kw)


# ---------------------------------------------------------------------------
# recover_service: the JAX package's whole-stack cases, port against port
# ---------------------------------------------------------------------------

def _run_live_service(cfg, bgc, batches, logd, rt_ckpt, bg_ckpt, tps,
                      snap_every=2):
    """Uninterrupted service run: log every tick, snapshot both engines
    every ``snap_every`` ticks. Returns (service, rt_states, bg_states),
    the states as host copies after each tick."""
    w = FirehoseLogWriter(str(logd), ticks_per_segment=tps)
    svc = AssistanceService(cfg, bg_cfg=bgc, device=CPU)
    rt_states, bg_states = {}, {}
    for t, (ev, tw) in enumerate(batches):
        w.append(t, ev, tw)
        svc.step(ev, tw)
        if (t + 1) % snap_every == 0:
            svc.save_snapshot(rt_ckpt, bg_ckpt)
        rt_states[t + 1] = svc.rt.state_arrays()
        bg_states[t + 1] = svc.bg.state_arrays()
    w.close()
    return svc, rt_states, bg_states


def _ranked(cfg, arrays):
    eng = SearchAssistanceEngine(cfg, device=CPU)
    eng.load_state_arrays(arrays)
    eng.run_rank_cycle()
    return eng.suggestions


@pytest.mark.parametrize("policy,layout", [
    ("lazy", "hash"), ("sweep", "hash"),
    ("lazy", "region"), ("sweep", "region")])
def test_service_crash_at_every_segment_boundary(tmp_path, policy, layout):
    """Crash the whole stack after every sealed log segment:
    ``recover_service`` reproduces the uninterrupted run bit for bit (each
    engine from its own delta-chained snapshot, replayed from its own
    offset under its own cadences), and the interpolated table with it."""
    n_ticks, tps = 9, 3
    cfg = _cfg(policy, cooc_layout=layout)
    bgc = _bg_cfg(cfg)
    logd = tmp_path / "log"
    rt_ckpt = CheckpointManager(str(tmp_path / "rt"), keep_n=20,
                                full_interval=3)
    bg_ckpt = CheckpointManager(str(tmp_path / "bg"), keep_n=20,
                                full_interval=3)
    _, rt_states, bg_states = _run_live_service(
        cfg, bgc, _batches(n_ticks, seed=17), logd, rt_ckpt, bg_ckpt, tps)
    assert "delta" in {rt_ckpt.manifest(s)["kind"] for s in rt_ckpt.steps()}
    n_checked = 0
    for boundary in range(tps, n_ticks + 1, tps):
        rt_steps = [s for s in rt_ckpt.steps() if s <= boundary]
        bg_steps = [s for s in bg_ckpt.steps() if s <= boundary]
        if not rt_steps or not bg_steps:
            continue
        # asymmetric offsets: rt restores its newest snapshot, bg an older
        rec, stats = recover_service(
            cfg, rt_ckpt, bg_ckpt, str(logd), ReplayConfig(chunk_ticks=4),
            bg_cfg=bgc, target_tick=boundary, rt_step=rt_steps[-1],
            bg_step=bg_steps[-2] if len(bg_steps) > 1 else bg_steps[-1],
            device=CPU)
        assert int(rec.rt.state.tick) == int(rec.bg.state.tick) == boundary
        assert stats["rt"]["restored_step"] == rt_steps[-1]
        assert stats["rt"]["n_ticks"] == boundary - rt_steps[-1]
        _bits_equal(rt_states[boundary], rec.rt.state_arrays())
        _bits_equal(bg_states[boundary], rec.bg.state_arrays())
        ref_rt = _ranked(cfg, rt_states[boundary])
        ref_bg = _ranked(bgc, bg_states[boundary])
        rec.rt.run_rank_cycle()
        rec.bg.run_rank_cycle()
        rec.refresh_cache()
        assert rec.rt.suggestions == ref_rt
        assert rec.bg.suggestions == ref_bg
        assert rec.suggestions == interpolate(ref_rt, ref_bg)
        n_checked += 1
    assert n_checked == 3


def test_recover_service_cold_engines(tmp_path):
    """A stack that crashed before its first persist cold-starts both
    engines and replays the whole retained log, still bit for bit."""
    cfg = _cfg("lazy")
    bgc = _bg_cfg(cfg)
    logd = tmp_path / "log"
    w = FirehoseLogWriter(str(logd), ticks_per_segment=3)
    live = AssistanceService(cfg, bg_cfg=bgc, device=CPU)
    for t, (ev, tw) in enumerate(_batches(6, seed=5)):
        w.append(t, ev, tw)
        live.step(ev, tw)
    w.close()
    rec, stats = recover_service(
        cfg, CheckpointManager(str(tmp_path / "rt")),
        CheckpointManager(str(tmp_path / "bg")), str(logd),
        ReplayConfig(chunk_ticks=4), bg_cfg=bgc, device=CPU)
    assert stats["rt"]["restored_step"] is None
    assert stats["bg"]["restored_step"] is None
    assert stats["rt"]["n_ticks"] == stats["bg"]["n_ticks"] == 6
    assert stats["rt"]["restore_ms"] == {} and stats["rt"]["restore"] == {}
    assert rec.rt.device.type == rec.bg.device.type == "cpu"
    _bits_equal(live.rt.state_arrays(), rec.rt.state_arrays())
    _bits_equal(live.bg.state_arrays(), rec.bg.state_arrays())
    assert rec.suggestions and rec.suggestions == interpolate(
        rec.rt.suggestions, rec.bg.suggestions)


def test_recover_engine_refuses_a_missing_snapshot(tmp_path):
    """``recover_engine`` (one engine) keeps refusing an empty snapshot
    directory, though it restores through the path that cold-starts the
    engines of ``recover_service``."""
    from repro_torch.streaming import recover_engine
    FirehoseLogWriter(str(tmp_path / "log")).close()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        recover_engine(_cfg(), CheckpointManager(str(tmp_path / "ck")),
                       str(tmp_path / "log"), device=CPU)


# ---------------------------------------------------------------------------
# serve_assist: the loop, crashed and resumed, against the uninterrupted run
# ---------------------------------------------------------------------------

ASSIST_CFG = EngineConfig(query_capacity=1 << 11, cooc_capacity=1 << 13,
                          session_capacity=1 << 10, decay_every=3,
                          rank_every=4)
ASSIST_TICKS = 61          # the spelling job at tick 60, a request at 60


def _assist(out, **kw):
    opts = serve_assist.AssistOptions(**{
        **dict(ticks=ASSIST_TICKS, out=str(out), replicas=2,
               fail_replica_at=-1, crash_at=-1, recover=False, full_every=4,
               slow_io_ms=0.0), **kw})
    return serve_assist.run(ASSIST_CFG, STREAM, opts, CPU,
                            log=lambda s: None)


def _ckpt_arrays(d):
    ck = CheckpointManager(str(d))
    return {s: (ck.load_arrays(s)[0], ck.manifest(s)["meta"])
            for s in ck.steps()}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    out = tmp_path_factory.mktemp("assist_ref")
    return out, _assist(out)


@pytest.mark.parametrize("crash_at,replayed", [(18, 0), (23, 3)],
                         ids=["mid-segment", "sealed-segment"])
def test_serve_assist_crash_and_recover_equals_uninterrupted(
        tmp_path, uninterrupted, crash_at, replayed):
    """Crash mid-segment (the writer's unsealed ticks are lost; the
    snapshot is newer than the log, nothing replays and the resumed run
    takes the lost ticks again from the hose) or right after a seal (the
    log holds every tick: 3 replayed a engine); resumed with ``recover``,
    the run ends equal to the uninterrupted one: engine states, the last
    state snapshots, every retained persisted suggestion table and the
    spelling table."""
    ref_dir, ref = uninterrupted
    crashed = _assist(tmp_path, crash_at=crash_at)
    assert crashed["crashed_at"] == crash_at and "final" not in crashed
    res = _assist(tmp_path, recover=True)
    rec = res["recover"]
    snap = (crash_at // ASSIST_CFG.rank_every) * ASSIST_CFG.rank_every + 1
    assert rec["rt"]["restored_step"] == rec["bg"]["restored_step"] == snap
    assert rec["rt"]["n_ticks"] == rec["bg"]["n_ticks"] == replayed
    assert res["start_tick"] == snap + replayed
    for got, exp in zip(res["backends"] + [res["bg"]],
                        ref["backends"] + [ref["bg"]]):
        _bits_equal(got.state_arrays(), exp.state_arrays())
    for sub in ("rt", "bg", "spell", os.path.join("state", "rt"),
                os.path.join("state", "bg")):
        got, exp = _ckpt_arrays(tmp_path / sub), _ckpt_arrays(ref_dir / sub)
        # retention keeps the newest steps (state dirs: and their chain
        # bases, which differ: a restarted manager writes a full first)
        common = got.keys() & exp.keys()
        assert max(got) == max(exp) and len(common) >= min(3, len(exp)), sub
        for s in common:
            _bits_equal(got[s][0], exp[s][0])
            assert {k: v for k, v in got[s][1].items() if k != "engine"} \
                == {k: v for k, v in exp[s][1].items() if k != "engine"}
    assert res["final"] == ref["final"]
    assert [r["route"] for r in res["requests"]] == \
        [r["route"] for r in ref["requests"]]
    assert res["spelling"][0]["corrections"] == \
        ref["spelling"][0]["corrections"] > 0


def test_serve_assist_records(uninterrupted):
    """What the loop reports: a request at tick 60 answered from the
    tick-60 table, snapshots full then delta, the spelling job's
    corrections persisted and served."""
    ref_dir, ref = uninterrupted
    (req,) = ref["requests"]
    assert req["t"] == 60 and req["route"].tick == 60
    assert req["route"].staleness == 0
    assert req["metrics"]["rt_lag_ticks"] == 0
    kinds = [s["rt"]["kind"] for s in ref["saves"]]
    assert kinds[:5] == ["full", "delta", "delta", "delta", "full"]
    assert len(ref["ticks"]) == ASSIST_TICKS
    assert all(r["stack_ms"] > 0 for r in ref["ticks"])
    assert all(r["draw_ms"] >= 0 for r in ref["ticks"])
    assert ref["start_tick"] == 0 and ref["skip_draw_ms"] >= 0
    fe = ref["frontends"][0]
    corr = CheckpointManager(str(ref_dir / "spell")).load_arrays()[0]
    wrong, right = (ref["tok"].text(int(corr[k][0])) for k in
                    ("leaf_0", "leaf_1"))
    assert fe.spelling(wrong) == right


def test_serve_assist_failover_and_slow_io(tmp_path, uninterrupted):
    """Replica 0 dies at tick 6: replica 1 takes over the log appends and
    the persists, so the log keeps every tick and the tables go on; a
    slowed log seal changes no result. The survivor ends bit for bit as
    the uninterrupted run's replicas."""
    _, ref = uninterrupted
    res = _assist(tmp_path, fail_replica_at=6, slow_io_ms=1.0)
    _bits_equal(res["backends"][1].state_arrays(),
                ref["backends"][0].state_arrays())
    _bits_equal(res["bg"].state_arrays(), ref["bg"].state_arrays())
    assert FirehoseLogReader(str(tmp_path / "log")).first_tick() == 0
    assert FirehoseLogReader(str(tmp_path / "log")).last_tick() == \
        ASSIST_TICKS - 1
    steps = CheckpointManager(str(tmp_path / "rt")).steps()
    assert steps == [52, 56, 60]
    assert [r["route"] for r in res["requests"]] == \
        [r["route"] for r in ref["requests"]]


def test_serve_assist_main_runs_on_the_cpu(tmp_path, capsys):
    assert serve_assist.main(["--device", "cpu", "--ticks", "13",
                              "--replicas", "1", "--out",
                              str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "[t=12] leader replica 0 persisted" in out
    assert "final suggestions for head query" in out
    assert CheckpointManager(str(tmp_path / "rt")).steps() == [12]


_DONE_FLEET = re.compile(
    r"\[done\] fleet: \d+ requests \(\d+ hedged\), (\d+) failovers, "
    r"(\d+) recoveries, log healed (\d+) ticks \((\d+) lost\), epoch "
    r"(\d+), (\d+) compactions \(floor=(\S+)\)")


def _fleet_counters(out: str):
    """The ``[done] fleet:`` line's failovers, recoveries, healed, lost,
    epoch, compactions and floor (hedges depend on the wall clock)."""
    (line,) = [m.groups() for m in map(_DONE_FLEET.search,
                                       out.splitlines()) if m]
    return line


@pytest.fixture(scope="module")
def _release_jax():
    """The JAX launcher's compiled executables (~4,000 memory maps of the
    worker process) are released after the module: XLA:CPU's maps count
    against the process's map limit, which the tier-1 run's JAX-heavy
    workers come close to."""
    yield
    import jax
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("argv", [
    ["--fleet", "3", "--ticks", "4"],
    ["--fleet", "3", "--ticks", "8", "--kill-leader-at", "1"],
    ["--fleet", "3", "--ticks", "8", "--kill-follower-at", "1"],
    ["--fleet", "3", "--ticks", "8", "--compact-every", "4"],
], ids=["fleet", "kill-leader", "kill-follower", "compact"])
def test_serve_assist_fleet_matches_the_jax_launcher(tmp_path, capsys,
                                                     monkeypatch, argv,
                                                     _release_jax):
    """``--fleet`` runs the port's ``ServingFleet`` at the JAX launcher's
    settings on the CPU; its ``[done] fleet:`` counters equal those of
    the JAX launcher's ``main`` on the same command line."""
    from repro.launch import serve_assist as jserve_assist
    monkeypatch.setattr(sys, "argv", ["serve_assist", "--out",
                                      str(tmp_path / "jax")] + argv)
    jserve_assist.main()
    want = _fleet_counters(capsys.readouterr().out)
    assert serve_assist.main(["--device", "cpu", "--out",
                              str(tmp_path / "port")] + argv) == 0
    out = capsys.readouterr().out
    assert _fleet_counters(out) == want
    assert "final suggestions" not in out        # the fleet path only
    if "--kill-leader-at" in argv:
        assert want[:2] == ("2", "1") and "KILLED mid-segment" in out
    if "--kill-follower-at" in argv:
        assert want[1] == "1" and "follower 1 killed" in out
    if "--compact-every" in argv:
        assert want[5] == "2" and want[6] == "8"


@pytest.mark.parametrize("argv", [
    ["--slo-ms", "60"], ["--tick-ms", "30"], ["--workload", "firehose"],
    ["--spike-at", "10"], ["--spike-mult", "5"], ["--compact-every", "1"],
    ["--keep-bases", "3"]], ids=lambda x: x[0])
def test_serve_assist_accepts_the_ported_flags(tmp_path, capsys, argv):
    """The overload, workload and compaction flags run (two ticks of the
    JAX launcher's settings on the CPU)."""
    assert serve_assist.main(["--device", "cpu", "--ticks", "2",
                              "--replicas", "1", "--out", str(tmp_path)]
                             + argv) == 0
    out = capsys.readouterr().out
    assert "final suggestions for head query" in out
    r = FirehoseLogReader(str(tmp_path / "log"))
    if argv[0] == "--compact-every":
        # folded into a base at tick 1: every segment lies below the floor
        assert "[t=1] compacted: floor=2" in out
        assert (r.floor_tick(), r.last_tick()) == (2, None)
    else:
        assert (r.floor_tick(), r.last_tick()) == (None, 1)
    if argv[0] == "--slo-ms":
        assert "[done] overload stats" in out


def test_serve_assist_has_no_use_kernel_flag(capsys):
    with pytest.raises(SystemExit):
        serve_assist.main(["--device", "cpu", "--use-kernel"])
    assert "--use-kernel" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Replicas after --recover: copies, not one shared state
# ---------------------------------------------------------------------------

def _leader_and_copy(n_ticks=5):
    cfg = _cfg("sweep", rank_every=4, decay_every=3)
    leader = SearchAssistanceEngine(cfg, device=CPU)
    batches = _batches(n_ticks + 6, seed=21)
    for ev, tw in batches[:n_ticks]:
        leader.step(ev, tw)
    own = SearchAssistanceEngine(cfg, device=CPU)
    own.load_state_arrays(leader.state_arrays())
    return cfg, leader, own, batches[n_ticks:]


def test_follower_replicas_stay_equal_to_a_replica_with_its_own_copy():
    """``serve_assist`` makes followers of a recovered leader with
    ``follower_replicas``; stepped with the leader (a decay and a rank
    cycle included) each stays bit for bit a replica that loaded its own
    copy, and no follower tensor shares storage with the leader's."""
    cfg, leader, own, rest = _leader_and_copy()
    followers = serve_assist.follower_replicas(leader, cfg, 2)
    assert [f.name for f in followers] == ["rt1", "rt2"]
    ptrs = lambda e: {v.untyped_storage().data_ptr() for v in
                      _tensors(e.state)}
    for f in followers:
        assert not ptrs(f) & ptrs(leader)
    for ev, tw in rest:
        for e in [leader, own] + followers:
            e.step(ev, tw)
    for e in [leader] + followers:
        _bits_equal(own.state_arrays(), e.state_arrays())
        assert e.suggestions == own.suggestions and own.suggestions


def test_replicas_sharing_one_state_diverge():
    """Why the followers copy: JAX shares one immutable state between
    replicas after a recovery, but the port's stores write in place, so
    two replicas stepping one shared state ingest every tick twice."""
    _, leader, own, rest = _leader_and_copy()
    alias = SearchAssistanceEngine(leader.cfg, device=CPU)
    alias.state = leader.state
    for ev, tw in rest:
        for e in (leader, alias, own):
            e.step(ev, tw)
    a, b = leader.state_arrays(), own.state_arrays()
    assert any(a[k].tobytes() != b[k].tobytes() for k in a)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, tuple):
        for v in x:
            yield from _tensors(v)


# ---------------------------------------------------------------------------
# Frontend staleness metrics: the replay floor from the log manifest
# ---------------------------------------------------------------------------

def test_frontend_reports_log_floor_and_lags(tmp_path):
    """``metrics()`` reads the log head, first tick and replay floor (the
    newest advertised compaction base, ``FirehoseLogReader.floor_tick``)
    and each half's lag behind the head."""
    log_dir = str(tmp_path / "log")
    w = FirehoseLogWriter(log_dir, ticks_per_segment=2)
    for t, (ev, tw) in enumerate(_batches(6)):
        w.append(t, ev, tw)
    w.close()
    man = os.path.join(log_dir, "firehose-MANIFEST.json")
    with open(man) as f:
        doc = json.load(f)
    doc["bases"] = [{"tick": 2}, {"tick": 4}]
    with open(man, "w") as f:
        json.dump(doc, f)
    assert FirehoseLogReader(log_dir).floor_tick() == 4
    CheckpointManager(str(tmp_path / "rt")).save(
        3, pack_suggestions({1: [(2, 1.0)]}), meta={"tick": 3})
    CheckpointManager(str(tmp_path / "bg")).save(
        1, pack_suggestions({1: [(3, 0.5)]}), meta={"log_tick": 2})
    fe = SuggestFrontend(str(tmp_path / "rt"), str(tmp_path / "bg"),
                         log_dir=log_dir)
    fe.stale_lag_ticks = 1     # below both lags: both halves catching up
    assert fe.poll() and not fe.poll()
    m = fe.metrics()
    assert (m["log_head_tick"], m["log_first_tick"], m["log_floor_tick"],
            m["n_log_bases"]) == (5, 0, 4, 2)
    assert (m["rt_tick"], m["bg_tick"]) == (3, 1)
    assert (m["rt_lag_ticks"], m["bg_lag_ticks"]) == (2, 4)
    assert m["rt_catching_up"] and m["bg_catching_up"]
    assert m["tuned_plan"] is None and m["tuned_variants"] is None
    assert fe.freshness_tick() == 3

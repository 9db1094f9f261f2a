"""The PyTorch port's self-healing replicated fleet, on the CPU.

The port against itself (the cases of ``tests/test_fleet.py``, at its
sizes): the chaos run — a 50x flash crowd, the log-writer leader killed
mid-segment AND a follower crashed, a third replica answering through a
slow disk while the fleet is whole — with zero failed requests, the
fenced zombie ex-leader refused, the durable log healed gap-free, and
every replica bit for bit against an uninterrupted port
``AssistanceService``; lag-gated readmission; a starved catch-up budget
that keeps a replica out of routing; compaction concurrent with a leader
kill, cold restarts through the bases.

Against the JAX package: one chaos schedule (leader and follower kills,
compaction, no slow disk, so routing is deterministic) through the JAX
``ServingFleet`` and the port's: every tick's ``offer_tick`` info, the
final ``metrics()``, the replica that answered each request, the log's
segments (ranges, epochs and bytes) and bases, and every replica's
final states under the parity contract of ``torch_parity.py``. The JAX
side runs once, in a module fixture.

Small checks: a heal-ring entry equals the workload's tick after the
replicas stepped it, a killed replica's service is freed at once, the
``alpha``/``log_name`` rule (the fleet's CUDA default is in
``test_torch_hygiene.py``). Everything is tick-clocked; no test reads a
wall clock.
"""
import gc
import time
import weakref
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro.core.decay import DecayConfig as JDecayConfig
from repro.core.engine import EngineConfig as JEngineConfig
from repro.distributed.fleet import FleetConfig as JFleetConfig
from repro.distributed.fleet import ServingFleet as JServingFleet
from repro.streaming import FirehoseLogReader as JLogReader
from repro.streaming import FirehoseWorkload as JWorkload
from repro.streaming import SpamSpec as JSpamSpec
from repro.streaming import SpikeSpec as JSpikeSpec
from repro.streaming import WorkloadConfig as JWorkloadConfig
from repro.streaming import log_bases as jlog_bases
from repro.streaming import log_epoch as jlog_epoch
from repro_torch.core.background import AssistanceService
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig
from repro_torch.distributed.fleet import FleetConfig, ServingFleet
from repro_torch.streaming import (FirehoseLogReader, FirehoseLogWriter,
                                   FirehoseWorkload, SpamSpec, SpikeSpec,
                                   WorkloadConfig, WriterFencedError,
                                   log_bases, log_epoch, slow_io)
from torch_parity import compare_states

CPU = torch.device("cpu")
CFG = dict(query_capacity=1 << 11, cooc_capacity=1 << 13,
           session_capacity=1 << 10, session_window=3, decay_every=4,
           prune_every=6, rank_every=5, region_width=16)
WL = dict(vocab_per_lang=128, n_langs=3, n_users=500,
          base_queries_per_tick=64, base_tweets_per_tick=8,
          min_bucket=64, min_tweet_bucket=8)


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


def _wl(seed=3, spike_mult=50.0, spike_at=6, **kw):
    """The JAX tests' small flash-crowd workload (tests/test_fleet.py)."""
    return FirehoseWorkload(WorkloadConfig(**{
        **WL, "spikes": (SpikeSpec(t_start=spike_at, mult=spike_mult),),
        "spam": SpamSpec(period=9, burst_ticks=2), **kw}), seed=seed)


def _fleet(tmp_path, fcfg, rt_cfg=None):
    return ServingFleet(str(tmp_path), rt_cfg or _cfg(), fcfg, device=CPU)


def _reference(fleet):
    return AssistanceService(fleet.rt_cfg, bg_cfg=fleet.bg_cfg, device=CPU)


def _bits_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _assert_replicas_equal_reference(fleet, ref):
    """Every replica's rt and bg state bit for bit the reference's."""
    want = (ref.rt.state_arrays(), ref.bg.state_arrays())
    for rep in fleet._replicas:
        _bits_equal(want[0], rep.service.rt.state_arrays())
        _bits_equal(want[1], rep.service.bg.state_arrays())


def _all_live(fleet):
    return all(r.status == "live" for r in fleet._replicas)


# ---------------------------------------------------------------------------
# The chaos run: 50x spike + leader killed mid-segment + follower killed +
# a slow replica — zero failed requests, fenced zombie refused, log
# gap-free, every replica bit for bit the uninterrupted service.
# ---------------------------------------------------------------------------

def test_fleet_chaos_leader_and_follower_kill_under_spike(tmp_path):
    fcfg = FleetConfig(n_replicas=3, heartbeat_timeout=2, restart_after=1,
                       snapshot_every=8, ticks_per_segment=4)
    fleet = _fleet(tmp_path, fcfg)
    wl = _wl(seed=3)                      # 50x flash crowd from t=6
    ref = _reference(fleet)

    # replica 2 answers through a slow disk while the fleet is whole; the
    # client's timeout discards its answers, so requests that try it first
    # hedge. Undone before the kills.
    ss = fleet.serverset(timeout_s=0.01, max_retries=1)
    slow_io(fleet.handles[2], ("related",), delay_s=0.05)

    probe = int(wl.fps[0])
    n_answered = 0
    torn = None
    t, n_ticks = 0, 24
    while t < n_ticks or (t < n_ticks + 16 and not _all_live(fleet)):
        ev, tw = wl.gen_tick(t)
        if t == 7:                        # kill the LEADER mid-segment
            fleet.handles[2]._slow_io_undo()
            assert fleet.leader() == 0
            torn = fleet.kill(0, mid_segment=True)
        if t == 12:                       # kill a follower (replica 2)
            assert fleet._replicas[2].status == "live" and fleet.leader() != 2
            fleet.kill(2)
        fleet.offer_tick(t, ev, tw)
        res = ss.request_info(probe)      # raises iff NO live replica answers
        assert isinstance(res.suggestions, list)
        n_answered += 1
        ref.step(ev, tw)
        t += 1

    assert n_answered == t >= n_ticks
    assert _all_live(fleet), fleet.metrics()
    assert torn is not None               # the crash really tore a segment
    assert ss.n_hedged > 0 and ss.n_timeouts > 0

    m = fleet.metrics()
    assert m["n_deaths_detected"] == 2 and m["n_recoveries"] == 2
    # failover 0->1 at detection, then 0 retakes on readmission
    assert m["n_failovers"] == 2 and m["epoch"] == 2
    assert m["leader"] == 0
    assert m["n_healed_ticks"] >= 3 and m["n_lost_ticks"] == 0
    fleet._replicas[fleet.leader()].writer.flush()
    reader = FirehoseLogReader(fleet.log_dir)
    ticks = [tk for tk, _, _ in reader.read_ticks(0)]
    assert ticks == list(range(t)), "durable log must be gap-free"

    # the fenced zombie: an ex-leader writer still at epoch 0 wakes up
    epoch = log_epoch(fleet.log_dir)
    assert epoch == m["epoch"] == 2
    segs_before = [(s.first, s.last, s.sha256) for s in reader.segments]
    zombie = FirehoseLogWriter(fleet.log_dir, ticks_per_segment=4, epoch=0)
    with pytest.raises(WriterFencedError):
        zombie.append(t + 100, ev, tw)
    with pytest.raises(WriterFencedError):
        zombie.assume_epoch(1)            # cannot rewind the fence either
    assert log_epoch(fleet.log_dir) == epoch
    reader.refresh()
    assert [(s.first, s.last, s.sha256) for s in reader.segments] \
        == segs_before

    assert set(fleet.states()) == {0, 1, 2}
    _assert_replicas_equal_reference(fleet, ref)
    assert [r.n_restarts for r in fleet._replicas] == [1, 0, 1]


# ---------------------------------------------------------------------------
# Lag-gated readmission
# ---------------------------------------------------------------------------

def test_replica_readmitted_only_when_lag_clears(tmp_path):
    """A restarted replica recovers to the SEALED log head only: until a
    seal covers the current tick it stays ``recovering``, out of routing;
    readmission comes exactly when catch-up reaches the live tick, and the
    readmitted state is bit for bit the uninterrupted run's."""
    fcfg = FleetConfig(n_replicas=2, heartbeat_timeout=0, restart_after=1,
                       catchup_budget_ticks=6, ticks_per_segment=4,
                       snapshot_every=4)
    fleet = _fleet(tmp_path, fcfg)
    # flat load, one query bucket size, no tweet lane: segments seal
    # exactly at ticks_per_segment boundaries
    wl = _wl(seed=5, spike_mult=1.0, min_bucket=256, base_tweets_per_tick=0)
    ref = _reference(fleet)
    ss = fleet.serverset()
    probe = int(wl.fps[0])
    status_at = {}
    for t in range(12):
        ev, tw = wl.gen_tick(t)
        if t == 4:
            fleet.kill(1)                 # follower: no failover involved
        fleet.offer_tick(t, ev, tw)
        res = ss.request_info(probe)
        status_at[t] = fleet._replicas[1].status
        if status_at[t] != "live":
            assert not fleet.handles[1].alive
            assert res.replica == 0 and res.attempts == 1
        ref.step(ev, tw)

    # killed before tick 4 -> detected at 4 -> restarted at 5 -> the log is
    # only sealed through 3 there, so it waits until the 4..7 seal at 7
    assert status_at[4] == "dead"
    assert status_at[5] == status_at[6] == "recovering"
    assert status_at[7] == "live"
    assert fleet.metrics()["n_recoveries"] == 1
    assert fleet.metrics()["n_failovers"] == 0   # leader 0 never wavered
    _assert_replicas_equal_reference(fleet, ref)


def test_starved_catchup_budget_keeps_replica_quarantined(tmp_path):
    """A catch-up budget slower than the hose never clears the lag: the
    replica stays out of routing while the survivor answers, yet makes
    budgeted progress behind the gate."""
    fcfg = FleetConfig(n_replicas=2, heartbeat_timeout=0, restart_after=1,
                       catchup_budget_ticks=1, ticks_per_segment=4,
                       snapshot_every=4)
    fleet = _fleet(tmp_path, fcfg)
    wl = _wl(seed=7, spike_mult=1.0, min_bucket=256, base_tweets_per_tick=0)
    ss = fleet.serverset()
    probe = int(wl.fps[0])
    for t in range(14):
        ev, tw = wl.gen_tick(t)
        if t == 4:
            fleet.kill(1)
        fleet.offer_tick(t, ev, tw)
        res = ss.request_info(probe)
        if t >= 4:
            assert res.replica == 0
    rep = fleet._replicas[1]
    assert rep.status == "recovering" and not fleet.handles[1].alive
    assert fleet.metrics()["n_recoveries"] == 0
    assert 4 < int(rep.service.rt.state.tick) < 15


# ---------------------------------------------------------------------------
# Compaction under chaos: the leader folds the log into bases on cadence
# WHILE being killed mid-segment; no snapshots at all, so restarts ride the
# bases; retention bounded; every replica bit for bit.
# ---------------------------------------------------------------------------

def test_fleet_chaos_compaction_concurrent_with_leader_kill(tmp_path):
    fcfg = FleetConfig(n_replicas=3, heartbeat_timeout=2, restart_after=1,
                       snapshot_every=0, ticks_per_segment=4,
                       compact_every=4, keep_bases=2)
    fleet = _fleet(tmp_path, fcfg)
    wl = _wl(seed=3)                      # 50x flash crowd from t=6
    ref = _reference(fleet)
    ss = fleet.serverset(timeout_s=0.5, max_retries=1)

    probe = int(wl.fps[0])
    n_answered = 0
    torn = None
    t, n_ticks = 0, 24
    while t < n_ticks or (t < n_ticks + 16 and not _all_live(fleet)):
        ev, tw = wl.gen_tick(t)
        if t == 7:                        # right after the t=3 compaction
            assert fleet.leader() == 0
            torn = fleet.kill(0, mid_segment=True)
        fleet.offer_tick(t, ev, tw)
        res = ss.request_info(probe)
        assert isinstance(res.suggestions, list)
        n_answered += 1
        ref.step(ev, tw)
        t += 1

    assert n_answered == t >= n_ticks
    assert _all_live(fleet), fleet.metrics()
    assert torn is not None

    m = fleet.metrics()
    assert m["n_deaths_detected"] == 1 and m["n_recoveries"] == 1
    # cycles landed both at epoch 0 (t=3) and under the new leader's epoch
    assert m["n_compactions"] >= 3
    assert m["n_log_bases"] == fcfg.keep_bases
    assert m["log_floor_tick"] >= 12
    assert max(int(b["epoch"]) for b in log_bases(fleet.log_dir)) >= 1

    # bounded retention, and the tail gap-free from the oldest base on
    fleet._replicas[fleet.leader()].writer.flush()
    reader = FirehoseLogReader(fleet.log_dir)
    retain_floor = min(int(b["tick"]) for b in reader.bases)
    assert retain_floor > 0
    assert reader.first_tick() == min(s.first for s in reader.segments)
    assert reader.first_tick() <= retain_floor
    assert all(s.last >= retain_floor for s in reader.segments)
    ticks = [tk for tk, _, _ in reader.read_ticks(reader.first_tick())]
    assert ticks == list(range(reader.first_tick(), t))

    # the restarted ex-leader recovered through the base tier
    rec = fleet._replicas[0].last_recovery
    assert rec["rt"]["base"] is not None and rec["bg"]["base"] is not None
    assert rec["rt"]["base"]["base_tick"] > 0
    assert rec["rt"]["restored_step"] is None     # no snapshot existed

    assert set(fleet.states()) == {0, 1, 2}
    _assert_replicas_equal_reference(fleet, ref)
    assert fleet._replicas[0].n_restarts == 1


# ---------------------------------------------------------------------------
# Against the JAX fleet: one schedule, both control planes
# ---------------------------------------------------------------------------

PARITY_FLEET = dict(n_replicas=3, heartbeat_timeout=2, restart_after=1,
                    snapshot_every=8, ticks_per_segment=4, compact_every=4,
                    keep_bases=2)
# flat load in one query and one tweet bucket (spam bursts included): one
# shape a tick, so the JAX side compiles each path once
PARITY_WL = dict(WL, min_bucket=256, min_tweet_bucket=32,
                 spikes=(dict(t_start=6, mult=1.0),),
                 spam=dict(period=9, burst_ticks=2))
PARITY_KILLS = {7: (0, True), 12: (2, False)}    # tick: (rid, mid-segment)
PARITY_TICKS = 24


class _ZipClock:
    """``zipfile``'s view of ``time`` with ``localtime`` pinned: a segment
    file is an ``np.savez`` zip whose entries carry the wall clock's date,
    so two runs write the same bytes only under one pinned date."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def localtime(*_):
        return time.struct_time((2000, 1, 1, 0, 0, 0, 5, 1, 0))


def _run_parity(fleet, gen_tick, lib):
    """Drive the parity schedule; returns per-tick infos, the answering
    replica of each request, the final metrics and the log's segments,
    epoch and bases (the fleet's own reader module)."""
    reader_cls, epoch_of, bases_of = lib
    ss = fleet.serverset()
    infos, routes = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(zipfile, "time", _ZipClock())
        t = 0
        while t < PARITY_TICKS or (t < PARITY_TICKS + 16
                                   and not _all_live(fleet)):
            ev, tw = gen_tick(t)
            if t in PARITY_KILLS:
                rid, mid = PARITY_KILLS[t]
                fleet.kill(rid, mid_segment=mid)
            infos.append(fleet.offer_tick(t, ev, tw))
            routes.append(ss.request_info("breaking0 term0").replica)
            t += 1
        fleet._replicas[fleet.leader()].writer.flush()
    reader = reader_cls(fleet.log_dir)
    return {"infos": infos, "routes": routes, "metrics": fleet.metrics(),
            "segments": [(s.first, s.last, s.n_ticks, s.sha256, s.raw_sha256)
                         for s in reader.segments],
            "epoch": epoch_of(fleet.log_dir),
            "bases": [(b["tick"], b["epoch"], b["engines"])
                      for b in bases_of(fleet.log_dir)],
            "states": {r.rid: (r.service.rt.state_arrays(),
                               r.service.bg.state_arrays())
                       for r in fleet._replicas},
            "thresholds": (fleet.rt_cfg.decay.prune_threshold,
                           fleet.bg_cfg.decay.prune_threshold)}


def _parity_workload(cls, cfg_cls, spike_cls, spam_cls):
    wl = dict(PARITY_WL)
    wl["spikes"] = tuple(spike_cls(**s) for s in wl["spikes"])
    wl["spam"] = spam_cls(**wl["spam"])
    return cls(cfg_cls(**wl), seed=3)


@pytest.fixture(scope="module")
def jax_fleet_run(tmp_path_factory):
    """The JAX fleet under the parity schedule, run once. Its compiled
    executables (~10,000 memory maps of the worker process) are released
    after the run: XLA:CPU's maps count against the process's map limit,
    which the tier-1 run's JAX-heavy workers come close to."""
    jcfg = JEngineConfig(**CFG, decay=JDecayConfig(policy="lazy"))
    fleet = JServingFleet(str(tmp_path_factory.mktemp("jax_fleet")), jcfg,
                          JFleetConfig(**PARITY_FLEET))
    wl = _parity_workload(JWorkload, JWorkloadConfig, JSpikeSpec, JSpamSpec)
    out = _run_parity(fleet, wl.gen_tick,
                      (JLogReader, jlog_epoch, jlog_bases))
    del fleet, wl
    jax.clear_caches()
    gc.collect()
    return out


def test_fleet_matches_jax_fleet(tmp_path, jax_fleet_run):
    fleet = _fleet(tmp_path, FleetConfig(**PARITY_FLEET))
    wl = _parity_workload(FirehoseWorkload, WorkloadConfig, SpikeSpec,
                          SpamSpec)
    got = _run_parity(fleet, wl.gen_tick,
                      (FirehoseLogReader, log_epoch, log_bases))
    exp = jax_fleet_run
    # the schedule did what it is for: both kills detected and healed,
    # two failovers, compaction before and after them
    assert any(i.get("compacted") for i in exp["infos"][:8])
    assert any(i.get("compacted") for i in exp["infos"][12:])
    assert exp["metrics"]["n_recoveries"] == 2
    assert got["infos"] == exp["infos"]
    assert got["metrics"] == exp["metrics"]
    assert got["routes"] == exp["routes"]
    assert got["epoch"] == exp["epoch"] == 2
    assert got["bases"] == exp["bases"]
    assert got["segments"] == exp["segments"]
    assert got["thresholds"] == pytest.approx(exp["thresholds"])
    flips = {}
    for rid, (j_rt, j_bg) in exp["states"].items():
        t_rt, t_bg = got["states"][rid]
        flips[rid] = (compare_states(j_rt, t_rt, exp["thresholds"][0]),
                      compare_states(j_bg, t_bg, exp["thresholds"][1]))
    print(f"prune flips per replica (rt, bg): {flips}")


# ---------------------------------------------------------------------------
# Small checks
# ---------------------------------------------------------------------------

def test_heal_ring_holds_the_workloads_ticks_after_the_step(tmp_path):
    """The ring keeps host arrays that neither ``service.step`` nor the log
    append mutates: each entry, re-appended at a failover, is the
    workload's tick."""
    fleet = _fleet(tmp_path, FleetConfig(n_replicas=2, ticks_per_segment=2))
    wl = _wl(seed=3)
    for t in range(5):
        fleet.offer_tick(t, *wl.gen_tick(t))
    for rep in fleet._replicas:
        assert [t for t, _, _ in rep.recent] == list(range(5))
        for t, ev, tw in rep.recent:
            want_ev, want_tw = wl.gen_tick(t)
            for a, b in zip(ev + tw, want_ev + want_tw):
                assert isinstance(a, np.ndarray)
                np.testing.assert_array_equal(a, b)


def test_kill_frees_the_replicas_service(tmp_path):
    """Nothing but the replica holds its service: the handle, the
    ServerSet and the recovery stats do not, so a kill frees the engines'
    tensors before a restart builds new ones."""
    fleet = _fleet(tmp_path, FleetConfig(n_replicas=2, ticks_per_segment=2))
    ss = fleet.serverset()
    wl = _wl(seed=3)
    for t in range(3):
        fleet.offer_tick(t, *wl.gen_tick(t))
        ss.request_info(int(wl.fps[0]))
    gone = [weakref.ref(x) for x in (
        fleet._replicas[1].service, fleet._replicas[1].service.rt,
        fleet._replicas[1].service.rt.state.cooc.key_hi)]
    fleet.kill(1)
    assert [r() for r in gone] == [None, None, None]
    with pytest.raises(ConnectionError):
        fleet.handles[1].related(int(wl.fps[0]))
    assert fleet.handles[1].alive        # not detected yet
    assert fleet.handles[1].freshness_tick() is None


@pytest.mark.parametrize("field,value", [("alpha", 0.5),
                                         ("log_name", "hose")])
def test_fleet_config_takes_only_the_ports_constants(field, value):
    """The port's service, recovery and compactor use ``ALPHA`` and
    ``LOG_NAME``; the fleet keeps JAX's two fields and refuses any other
    value (the defaults, the constants, are accepted)."""
    with pytest.raises(ValueError, match=field):
        FleetConfig(**{field: value})
    assert FleetConfig(alpha=0.7, log_name="firehose") == FleetConfig()


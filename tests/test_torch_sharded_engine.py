"""The PyTorch port's sharded engine (CPU) against the JAX package's.

The JAX sharded engine needs 8 devices, which XLA makes only when told
before it starts, so each JAX schedule runs in a subprocess (as
``tests/test_sharded_engine.py`` runs them) and writes its leaves, tables
and stats to an ``.npz``; the port runs here on ``device="cpu"``. States
are held leaf by leaf (``jax.tree.flatten(ShardedState)`` order) under the
contract of ``torch_parity.py``, with every prune flip counted and
printed. The cases:

  1. JAX's first schedule (hash layout, 6 ticks of step, decay and rank):
     the state, the per-shard ``SuggestionTable`` and the
     ``merge_sharded_suggestions`` dict;
  2. JAX's replay schedule (lazy policy): the live state, delta-chained
     snapshots loaded across both ways, and the replayed state;
  3. ``reshard_sharded_state`` 2 -> 4 and 4 -> 2 on a state equal to
     JAX's, both layouts, leaf for leaf; ``live_reshard`` over a log the
     port wrote (JAX's split schedule), bit-reproducible;
  4. ``ShardAutoscaler`` and ``sharded_pressure`` against JAX's;
  5. ``_route`` at a capacity that overflows: the same buckets and drops;
  6. sharded against unsharded in the port alone (JAX's first test).
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import sharded_engine as se
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.core.hashing import split_fp
from repro_torch.data.stream import StreamConfig, SyntheticStream
from repro_torch.distributed import elastic
from repro_torch.distributed.fault_tolerance import CheckpointManager
from repro_torch.streaming.log import FirehoseLogWriter
from torch_parity import LAYOUTS, compare_states, compare_suggestions

CPU = "cpu"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CFG = dict(query_capacity=1 << 12, cooc_capacity=1 << 15,
           session_capacity=1 << 12, session_window=4)
EAGER = dict(CFG, decay_every=4, rank_every=0)
LAZY = dict(CFG, decay_every=3, prune_every=5, rank_every=0)
SCFG = dict(n_salts=2, hot_threshold=30.0, route_capacity=1024)
STREAM = dict(vocab_size=256, n_users=200, queries_per_tick=192,
              tweets_per_tick=0)
THRESH = DecayConfig().prune_threshold

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small ops: one intra-op thread keeps them from
    oversubscribing the cores the other test workers and the JAX
    subprocesses share (restored after each test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Shared head of every JAX script: argv[1] is the .npz to write.
_PRELUDE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import sharded_engine as se
from repro.core.decay import DecayConfig
from repro.core.engine import EngineConfig
from repro.core.hashing import split_fp
from repro.data.stream import StreamConfig, SyntheticStream
assert len(jax.devices()) == 8
OUT = sys.argv[1]
DEVS = np.array(jax.devices())
out = {}

def mesh(n):
    return Mesh(DEVS[:n], ("shard",))

def config(kw, lazy, layout="hash"):
    extra = dict(decay=DecayConfig(policy="lazy")) if lazy else {}
    ecfg = EngineConfig(**kw, cooc_layout=layout, region_width=16, **extra)
    return ecfg, se.ShardedConfig(base=ecfg, **%(scfg)r)

def batches(n):
    stream = SyntheticStream(StreamConfig(**%(stream)r), seed=5)
    res = []
    for t in range(n):
        ev, _ = stream.gen_tick(t)
        s_hi, s_lo = split_fp(ev.sess_fp); q_hi, q_lo = split_fp(ev.q_fp)
        res.append(tuple(jnp.asarray(x) for x in
                         (s_hi, s_lo, q_hi, q_lo, ev.src.astype(np.int32),
                          ev.valid)))
    return res

def keep(name, state):
    for i, x in enumerate(jax.tree.flatten(state)[0]):
        out[f"{name}/leaf_{i}"] = np.asarray(x)
"""


def _run_jax(tmp_path, body: str, *args) -> dict:
    """Run a JAX script on 8 virtual CPU devices (Eigen's thread pool off:
    the engine has no op that uses it); returns its npz."""
    script = (_PRELUDE % {"scfg": SCFG, "stream": STREAM}
              + textwrap.dedent(body) + "\nnp.savez(OUT, **out)\n")
    path = str(tmp_path / "jax_out.npz")
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTEST_ALLOW_DEVICES"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    r = subprocess.run([sys.executable, "-c", script, path, *map(str, args)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-4000:]}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _leaves(arrs: dict, name: str) -> dict:
    pre = f"{name}/"
    return {k[len(pre):]: v for k, v in arrs.items() if k.startswith(pre)}


def _config(kw, lazy, layout="hash"):
    extra = dict(decay=DecayConfig(policy="lazy")) if lazy else {}
    ecfg = EngineConfig(**kw, cooc_layout=layout, region_width=16, **extra)
    return ecfg, se.ShardedConfig(base=ecfg, **SCFG)


def _ticks(n):
    stream = SyntheticStream(StreamConfig(**STREAM), seed=5)
    return [stream.gen_tick(t)[0] for t in range(n)]


def _lanes(ev):
    s_hi, s_lo = split_fp(ev.sess_fp)
    q_hi, q_lo = split_fp(ev.q_fp)
    return s_hi, s_lo, q_hi, q_lo, ev.src.astype(np.int32), ev.valid


def _stacked(evs):
    return tuple(np.stack(x) for x in zip(*map(_lanes, evs)))


def _exact(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def _merged_from(arrs: dict, name: str) -> dict:
    m: dict = {}
    for s, d, sc in zip(arrs[f"{name}/src"], arrs[f"{name}/dst"],
                        arrs[f"{name}/score"]):
        m.setdefault(int(s), []).append((int(d), float(sc)))
    return m


_TABLE = ("src_hi", "src_lo", "dst_hi", "dst_lo", "score", "n_rows",
          "n_overflow")


def _compare_tables(jt: dict, tab) -> None:
    """Per-shard SuggestionTable: rows, sources, destinations and counts
    exact, scores within rtol 5e-3, atol 1e-4."""
    for k in _TABLE:
        x = getattr(tab, k).cpu().numpy()
        if k == "score":
            np.testing.assert_allclose(x, jt[k], rtol=5e-3, atol=1e-4)
        else:
            np.testing.assert_array_equal(x, jt[k].view(x.dtype), err_msg=k)


# --------------------------------------------------------------------------
# 1. JAX's first schedule: hash layout, step + decay + rank.
# --------------------------------------------------------------------------

_FIRST = """
ecfg, scfg = config(%(cfg)r, lazy=False)
m = mesh(8)
step, decay, rank = (se.make_sharded_step(scfg, m),
                     se.make_sharded_decay(scfg, m), se.make_sharded_rank(scfg, m))
state = se.init_sharded_state(scfg, m)
for t, b in enumerate(batches(6)):
    state = step(state, *b)
    if t > 0 and t %% ecfg.decay_every == 0:
        state = decay(state, jnp.int32(ecfg.decay_every))
    state = state._replace(tick=state.tick + 1)
keep("s", state)
tab = rank(state)
for k in %(table)r:
    out[f"t/{k}"] = np.asarray(getattr(tab, k))
merged = se.merge_sharded_suggestions(tab, ecfg.rank.top_k)
rows = [(s, d, sc) for s in sorted(merged) for d, sc in merged[s]]
out["m/src"] = np.array([r[0] for r in rows], np.uint64)
out["m/dst"] = np.array([r[1] for r in rows], np.uint64)
out["m/score"] = np.array([r[2] for r in rows], np.float64)
"""


def test_first_schedule_state_tables_and_merge_match_jax(tmp_path):
    jx = _run_jax(tmp_path, _FIRST % {"cfg": EAGER, "table": _TABLE})
    ecfg, scfg = _config(EAGER, lazy=False)
    step = se.make_sharded_step(scfg, 8, device=CPU)
    decay = se.make_sharded_decay(scfg, 8, device=CPU)
    rank = se.make_sharded_rank(scfg, 8, device=CPU)
    state = se.init_sharded_state(scfg, 8, device=CPU)
    for t, ev in enumerate(_ticks(6)):
        state = step(state, *_lanes(ev))
        if t > 0 and t % ecfg.decay_every == 0:
            state = decay(state, ecfg.decay_every)
        state = state._replace(tick=state.tick + 1)
    got = se.sharded_state_arrays(state)
    flips = compare_states(_leaves(jx, "s"), got, THRESH, "sharded-hash")
    print(f"prune flips, sharded hash state vs JAX: {flips}")
    assert int(state.n_route_drop.sum()) == 0
    tab = rank(state)
    _compare_tables(_leaves(jx, "t"), tab)
    merged = se.merge_sharded_suggestions(tab, ecfg.rank.top_k)
    share = compare_suggestions(_merged_from(jx, "m"), merged)
    print(f"merged suggestions: {len(merged)} sources, top-3 identity "
          f"agreement {share:.4f}")
    assert merged


# --------------------------------------------------------------------------
# 2. JAX's replay schedule: lazy policy, delta-chained snapshots both ways.
# --------------------------------------------------------------------------

_REPLAY = """
from repro.distributed.fault_tolerance import CheckpointManager
ecfg, scfg = config(%(cfg)r, lazy=True)
m = mesh(8)
tick_step = se.make_sharded_tick_step(scfg, m)
many = se.make_sharded_ingest_many(scfg, m)
bs = batches(8)
live = se.init_sharded_state(scfg, m)
for b in bs:
    live = tick_step(live, *b)
keep("live", live)
half = se.init_sharded_state(scfg, m)
ckpt = CheckpointManager(sys.argv[2], full_interval=4)
for i, b in enumerate(bs[:4]):
    half = tick_step(half, *b)
    if i in (1, 3):
        se.save_sharded_snapshot(half, ckpt)
assert ckpt.last_save_kind == "delta", ckpt.last_save_kind
restored, log_tick = se.restore_sharded_snapshot(scfg, m, ckpt)
assert log_tick == 4
keep("restored", restored)
stacked = tuple(jnp.stack([b[i] for b in bs[4:]]) for i in range(6))
keep("caught_up", many(restored, *stacked))
# the port's delta-chained snapshot, restored by the JAX engine
port_ckpt = CheckpointManager(sys.argv[3])
assert port_ckpt.manifest()["kind"] == "delta"
from_port, port_tick = se.restore_sharded_snapshot(scfg, m, port_ckpt)
assert port_tick == 4
keep("from_port", from_port)
"""


def test_replay_schedule_and_snapshots_cross_load_with_jax(tmp_path):
    ecfg, scfg = _config(LAZY, lazy=True)
    evs = _ticks(8)
    tick_step = se.make_sharded_tick_step(scfg, 8, device=CPU)
    many = se.make_sharded_ingest_many(scfg, 8, device=CPU)
    live = se.init_sharded_state(scfg, 8, device=CPU)
    for ev in evs:
        live = tick_step(live, *_lanes(ev))
    half = se.init_sharded_state(scfg, 8, device=CPU)
    port_dir = tmp_path / "port_ckpt"
    ckpt = CheckpointManager(str(port_dir), full_interval=4)
    for i, ev in enumerate(evs[:4]):
        half = tick_step(half, *_lanes(ev))
        if i in (1, 3):
            se.save_sharded_snapshot(half, ckpt)
    assert ckpt.last_save_kind == "delta"
    assert ckpt.manifest()["meta"] == {"log_tick": 4, "engine": "sharded"}
    half_arrays = se.sharded_state_arrays(half)

    jax_dir = tmp_path / "jax_ckpt"
    jx = _run_jax(tmp_path, _REPLAY % {"cfg": LAZY}, jax_dir, port_dir)

    # the port's live run against JAX's
    flips = compare_states(_leaves(jx, "live"), se.sharded_state_arrays(live),
                           THRESH, "sharded-hash")
    print(f"prune flips, lazy live run vs JAX: {flips}")
    # each engine restores the other's delta chain exactly
    _exact(_leaves(jx, "from_port"), half_arrays)
    restored, log_tick = se.restore_sharded_snapshot(
        scfg, 8, CheckpointManager(str(jax_dir)), device=CPU)
    assert log_tick == 4
    _exact(se.sharded_state_arrays(restored), _leaves(jx, "restored"))
    # replay of the JAX snapshot against JAX's replay
    caught_up = many(restored, *_stacked(evs[4:]))
    flips = compare_states(_leaves(jx, "caught_up"),
                           se.sharded_state_arrays(caught_up), THRESH,
                           "sharded-hash")
    print(f"prune flips, replay from JAX's snapshot vs JAX: {flips}")
    # the port's own snapshot and replay, bit for bit its live run
    own, _ = se.restore_sharded_snapshot(scfg, 8, ckpt, device=CPU)
    _exact(se.sharded_state_arrays(own), half_arrays)
    own = many(own, *_stacked(evs[4:]))
    _exact(se.sharded_state_arrays(own), se.sharded_state_arrays(live))


# --------------------------------------------------------------------------
# 3. Reshard 2 -> 4 -> 2 and live_reshard over the port's log.
# --------------------------------------------------------------------------

_RESHARD = """
ecfg, scfg = config(%(cfg)r, lazy=True, layout=%(layout)r)
step2 = se.make_sharded_tick_step(scfg, mesh(2))
st = se.init_sharded_state(scfg, mesh(2))
for b in batches(8):
    st = step2(st, *b)
keep("st", st)
r4, s4 = se.reshard_sharded_state(scfg, st, 4)
keep("r4", r4)
r2, s2 = se.reshard_sharded_state(scfg, r4, 2)
keep("r2", r2)
out["stats"] = np.array(json.dumps([s4, s2]))
"""


def _run_with_live_split(scfg, ecfg, evs, logd):
    """JAX's split schedule on the port: 2 shards to tick 8; the old state
    serves ticks 8-9 while the snapshot is split to 4 shards and caught
    up from the log; then 4 shards serve ticks 10-11."""
    step2 = se.make_sharded_tick_step(scfg, 2, device=CPU)
    step4 = se.make_sharded_tick_step(scfg, 4, device=CPU)
    rank2 = se.make_sharded_rank(scfg, 2, device=CPU)
    rank4 = se.make_sharded_rank(scfg, 4, device=CPU)
    st = se.init_sharded_state(scfg, 2, device=CPU)
    for ev in evs[:8]:
        st = step2(st, *_lanes(ev))
    old = se.clone_sharded_state(st)
    for ev in evs[8:10]:
        old = step2(old, *_lanes(ev))      # zero downtime: old serves 8, 9
    new, stats = elastic.live_reshard(scfg, st, 4, 4, log_dir=logd,
                                      chunk_ticks=4, device=CPU)
    assert stats["old_n"] == 2 and stats["new_n"] == 4
    assert stats["replayed_ticks"] == 2, stats
    assert stats["n_pair_drop"] == 0 and stats["n_sess_drop"] == 0
    assert int(new.tick) == 10 == int(old.tick)
    m_old = se.merge_sharded_suggestions(rank2(old), ecfg.rank.top_k)
    m_new = se.merge_sharded_suggestions(rank4(new), ecfg.rank.top_k)
    assert m_old
    assert set(m_new) == set(m_old)
    # resharding sums salted fragments, the live merge takes their max:
    # no source's top score may fall across the handoff
    top = lambda m: {f: max(s for _, s in v) for f, v in m.items() if v}
    t_old, t_new = top(m_old), top(m_new)
    assert all(t_new[f] >= t_old[f] - 1e-5 for f in t_old)
    for ev in evs[10:]:
        new = step4(new, *_lanes(ev))
    return new, stats


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_reshard_and_live_reshard_match_jax(tmp_path, layout):
    ecfg, scfg = _config(LAZY, lazy=True, layout=layout)
    evs = _ticks(12)
    jx = _run_jax(tmp_path, _RESHARD % {"cfg": LAZY, "layout": layout})
    j4, j2 = json.loads(str(jx["stats"]))

    # reshard on a state equal to JAX's, leaf for leaf
    st = se.load_sharded_state_arrays(scfg, _leaves(jx, "st"), 2, device=CPU)
    r4, s4 = se.reshard_sharded_state(scfg, st, 4)
    assert s4 == j4
    _exact(se.sharded_state_arrays(r4), _leaves(jx, "r4"))
    r4 = se.load_sharded_state_arrays(scfg, _leaves(jx, "r4"), 4, device=CPU)
    r2, s2 = se.merge_shards(scfg, r4)
    assert s2 == j2
    _exact(se.sharded_state_arrays(r2), _leaves(jx, "r2"))
    print(f"{layout}: {s4['n_pairs']} pairs, {s4['n_sessions']} sessions "
          f"resharded 2 -> 4 -> 2 as JAX does")

    # the port's own 2-shard run is JAX's under the parity contract
    step2 = se.make_sharded_tick_step(scfg, 2, device=CPU)
    own = se.init_sharded_state(scfg, 2, device=CPU)
    for ev in evs[:8]:
        own = step2(own, *_lanes(ev))
    flips = compare_states(_leaves(jx, "st"), se.sharded_state_arrays(own),
                           THRESH, f"sharded-{layout}")
    print(f"{layout}: prune flips, 2-shard lazy run vs JAX: {flips}")

    # the live split over a log the port wrote, twice: bit-reproducible
    logd = tmp_path / "log"
    w = FirehoseLogWriter(str(logd), ticks_per_segment=2)
    for t, ev in enumerate(evs[:10]):      # the log ends inside the window:
        w.append(t, ev, None)              # ticks 10, 11 come after the swap
    w.close()
    a, _ = _run_with_live_split(scfg, ecfg, evs, str(logd))
    b, _ = _run_with_live_split(scfg, ecfg, evs, str(logd))
    _exact(se.sharded_state_arrays(a), se.sharded_state_arrays(b))
    p = elastic.sharded_pressure(a, ecfg)
    assert p["route_drop"] == 0
    if layout == "region":
        assert 0.0 <= p["free_region_frac"] <= 1.0
    # scale back in: 4 -> 2 keeps every query answerable
    m4 = se.merge_sharded_suggestions(se.make_sharded_rank(
        scfg, 4, device=CPU)(a), ecfg.rank.top_k)
    merged, mstats = elastic.live_reshard(scfg, a, 2, 2, log_dir=str(logd),
                                          device=CPU)
    assert mstats["new_n"] == 2 and mstats["replayed_ticks"] == 0
    m2 = se.merge_sharded_suggestions(se.make_sharded_rank(
        scfg, 2, device=CPU)(merged), ecfg.rank.top_k)
    assert set(m2) == set(m4)


# --------------------------------------------------------------------------
# 4. The autoscaler and the pressure reading against JAX's.
# --------------------------------------------------------------------------

def test_autoscaler_and_pressure_match_jax():
    from repro.core.engine import EngineConfig as JEngineConfig
    from repro.distributed.elastic import AutoscaleConfig as JAutoscaleConfig
    from repro.distributed.elastic import ShardAutoscaler as JShardAutoscaler
    from repro.distributed.elastic import sharded_pressure as jpressure
    rng = np.random.default_rng(0)
    for hold, lo, hi in ((1, 1, 64), (2, 2, 8), (3, 1, 16), (4, 4, 4)):
        cfg = dict(hold_ticks=hold, min_shards=lo, max_shards=hi)
        ours = elastic.ShardAutoscaler(elastic.AutoscaleConfig(**cfg))
        theirs = JShardAutoscaler(JAutoscaleConfig(**cfg))
        n_ours = n_theirs = lo
        for _ in range(400):
            obs = dict(
                free_region_frac=(None if rng.random() < 0.2
                                  else float(rng.choice([0.02, 0.3, 0.9,
                                                         rng.random()]))),
                lag_ticks=float(rng.choice([0.0, 0.5, 3.0, 9.0])),
                route_drop_rate=float(rng.random() < 0.1))
            n_ours = ours.observe(n_ours, **obs)
            n_theirs = theirs.observe(n_theirs, **obs)
            assert n_ours == n_theirs
    for layout in ("hash", "region"):
        ecfg, scfg = _config(CFG, lazy=False, layout=layout)
        step = se.make_sharded_tick_step(scfg, 4, device=CPU)
        state = se.init_sharded_state(scfg, 4, device=CPU)
        for ev in _ticks(3):
            state = step(state, *_lanes(ev))
        state = state._replace(n_route_drop=torch.tensor(
            [0, 3, 0, 1], dtype=torch.int32))
        arrs = se.sharded_state_arrays(state)
        # JAX's reading needs only the stacked region owners and the drops
        owner = (arrs[f"leaf_{LAYOUTS['region']['exact']['region_owner']}"]
                 if layout == "region" else None)
        jstate = SimpleNamespace(
            n_route_drop=arrs[f"leaf_{len(arrs) - 1}"],
            cooc=SimpleNamespace(region_owner=owner))
        want = jpressure(jstate, JEngineConfig(**CFG, cooc_layout=layout,
                                               region_width=16))
        got = elastic.sharded_pressure(state, ecfg)
        assert got == want and got["route_drop"] == 4
        assert (got["free_region_frac"] is None) == (layout == "hash")


# --------------------------------------------------------------------------
# 5. _route at a capacity that overflows.
# --------------------------------------------------------------------------

_ROUTE = """
from functools import partial
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
z = np.load(sys.argv[2])
n, cap = 8, int(z["cap"])

def body(hi, lo, owner, w, valid):
    r_hi, r_lo, r_pl, r_valid, drop = se._route(
        hi, lo, owner, {"w": w}, valid, n, cap, "shard")
    return r_hi, r_lo, r_pl["w"], r_valid, drop[None]

sh = P("shard")
fn = jax.jit(shard_map(body, mesh=mesh(n), in_specs=(sh,) * 5,
                       out_specs=(sh,) * 5, check_rep=False))
res = fn(*(jnp.asarray(z[k].reshape(-1)) for k in
           ("hi", "lo", "owner", "w", "valid")))
for k, v in zip(("hi", "lo", "w", "valid", "drop"), res):
    out[k] = np.asarray(v)
"""


def test_route_buckets_and_drops_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    n, Bp, cap = 8, 640, 48
    # skewed owners: the first shards' buckets overflow, others stay short
    owner = np.minimum(rng.geometric(0.3, (n, Bp)) - 1, n - 1).astype(np.int32)
    inp = {"hi": rng.integers(0, 2**32, (n, Bp), dtype=np.uint32),
           "lo": rng.integers(0, 2**32, (n, Bp), dtype=np.uint32),
           "owner": owner, "w": rng.random((n, Bp), dtype=np.float32),
           "valid": rng.random((n, Bp)) < 0.8, "cap": np.array(cap)}
    inp["valid"][n - 1] &= rng.random(Bp) < 0.05   # one source stays short
    np.savez(tmp_path / "route_in.npz", **inp)
    jx = _run_jax(tmp_path, _ROUTE, tmp_path / "route_in.npz")
    t = {k: torch.from_numpy(inp[k]) for k in ("owner", "w", "valid")}
    hi, lo = (torch.from_numpy(inp[k].view(np.int32)) for k in ("hi", "lo"))
    r_hi, r_lo, r_pl, r_valid, drop = se._route(
        hi, lo, t["owner"].long(), {"w": t["w"]}, t["valid"], n, cap)
    np.testing.assert_array_equal(r_hi.numpy().view(np.uint32).reshape(-1),
                                  jx["hi"])
    np.testing.assert_array_equal(r_lo.numpy().view(np.uint32).reshape(-1),
                                  jx["lo"])
    np.testing.assert_array_equal(r_pl["w"].numpy().reshape(-1), jx["w"])
    np.testing.assert_array_equal(r_valid.numpy().reshape(-1), jx["valid"])
    np.testing.assert_array_equal(drop.numpy(), jx["drop"])
    assert drop.sum() > 0 and (drop == 0).any()
    print(f"route drops by source shard: {drop.tolist()}")


# --------------------------------------------------------------------------
# 6. Sharded against unsharded, in the port alone.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["hash", "region"])
def test_sharded_matches_unsharded_port(layout):
    ecfg, scfg = _config(EAGER, lazy=False, layout=layout)
    step = se.make_sharded_step(scfg, 8, device=CPU)
    decay = se.make_sharded_decay(scfg, 8, device=CPU)
    rank = se.make_sharded_rank(scfg, 8, device=CPU)
    state = se.init_sharded_state(scfg, 8, device=CPU)
    eng = SearchAssistanceEngine(ecfg, device=CPU)
    for t, ev in enumerate(_ticks(6)):
        state = step(state, *_lanes(ev))
        eng.step(ev, None)
        if t > 0 and t % ecfg.decay_every == 0:
            state = decay(state, ecfg.decay_every)
        state = state._replace(tick=state.tick + 1)
    assert int(state.n_route_drop.sum()) == 0
    # the shared query store is the unsharded engine's, bit for bit
    got, want = se.sharded_state_arrays(state), eng.state_arrays()
    for i in range(6):
        np.testing.assert_array_equal(got[f"leaf_{i}"], want[f"leaf_{i}"])
    merged = se.merge_sharded_suggestions(rank(state), ecfg.rank.top_k)
    eng.run_rank_cycle()
    ref = eng.suggestions
    assert merged and set(merged) == set(ref)
    for f in merged:
        ms = sorted([s for _, s in merged[f]], reverse=True)[:3]
        rs = sorted([s for _, s in ref[f]], reverse=True)[:3]
        np.testing.assert_allclose(ms, rs, rtol=5e-3, atol=1e-4)


def _fragmented_sources(state):
    """Sources with a (src, dst) pair in more than one hash shard."""
    from repro_torch.core.hashing import join_fp
    from repro_torch.core.stores import export_live
    keys = []
    for c in state.cooc:
        e = export_live(c)
        keys += list(zip(join_fp(e["src_hi"], e["src_lo"]).tolist(),
                         join_fp(e["dst_hi"], e["dst_lo"]).tolist()))
    seen, frag = set(), set()
    for s, d in keys:
        if (s, d) in seen:
            frag.add(s)
        seen.add((s, d))
    return frag


def test_only_fragmented_sources_leave_the_unsharded_contract():
    """At 1/32 of the hash cell's widths with ShardedConfig's defaults,
    sources cross hot_threshold mid-run: their later pairs are salted to
    other shards, so one (src, dst) pair lives in two shards and the merge
    takes the larger fragment's score where the unsharded engine scores
    the sum. Every other source holds the top-3 contract; the key sets are
    equal and the query store is bit for bit the unsharded one."""
    ecfg = EngineConfig(query_capacity=1 << 17, cooc_capacity=1 << 19,
                        session_capacity=1 << 15, decay_every=4,
                        rank_every=16, ingest_quantum=0)
    scfg = se.ShardedConfig(base=ecfg)
    stream = SyntheticStream(StreamConfig(vocab_size=2048, n_users=6250,
                                          queries_per_tick=512,
                                          tweets_per_tick=0), seed=0)
    step = se.make_sharded_tick_step(scfg, 8, device=CPU)
    state = se.init_sharded_state(scfg, 8, device=CPU)
    eng = SearchAssistanceEngine(ecfg, device=CPU)
    for t in range(17):
        ev, _ = stream.gen_tick(t)
        state = step(state, *_lanes(ev))
        eng.step(ev, None)
    assert int(state.n_route_drop.sum()) == 0
    got, want = se.sharded_state_arrays(state), eng.state_arrays()
    for i in range(6):
        np.testing.assert_array_equal(got[f"leaf_{i}"], want[f"leaf_{i}"])
    merged = se.merge_sharded_suggestions(
        se.make_sharded_rank(scfg, 8, device=CPU)(state), ecfg.rank.top_k)
    ref = eng.suggestions
    assert merged and set(merged) == set(ref)
    frag = _fragmented_sources(state) & set(merged)
    off = []
    for f in merged:
        ms = sorted([s for _, s in merged[f]], reverse=True)[:3]
        rs = sorted([s for _, s in ref[f]], reverse=True)[:3]
        if not (len(ms) == len(rs)
                and np.allclose(ms, rs, rtol=5e-3, atol=1e-4)):
            off.append(f)
    print(f"{len(merged)} sources, {len(frag)} fragmented, {len(off)} off "
          f"the top-3 contract")
    assert set(off) <= frag and off


def test_reshard_refuses_shard_counts_that_do_not_divide():
    _, scfg = _config(CFG, lazy=False)
    state = se.init_sharded_state(scfg, 2, device=CPU)
    with pytest.raises(ValueError, match="power of two"):
        se.reshard_sharded_state(scfg, state, 3)
    with pytest.raises(ValueError, match="odd"):
        se.merge_shards(scfg, se.init_sharded_state(scfg, 1, device=CPU))
    with pytest.raises(ValueError, match="replaying on 2 shards"):
        elastic.live_reshard(scfg, state, 4, 2, device=CPU)
    with pytest.raises(ValueError, match="shards"):
        se.make_sharded_step(scfg, 4, device=CPU)(
            state, *_lanes(_ticks(1)[0]))

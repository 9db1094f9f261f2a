"""The PyTorch port's stores against the JAX package on adversarial batches:
duplicate keys, full probe sequences (drops), batches larger than the
31-bit packed claim key allows, lookups and session updates. Keys, slots,
lanes and drop counts must be exact."""
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import stores as js
from repro.core.decay import DecayConfig as JDecayConfig
from repro_torch.core import stores as ts
from repro_torch.core.decay import DecayConfig
from repro_torch.core.hashing import from_np_u32, to_np_u32

MODES = (("weight", "add"), ("count", "add"), ("last_tick", "set"))
J_LANES = {"weight": jnp.float32, "count": jnp.float32,
           "last_tick": jnp.int32}
T_LANES = {"weight": torch.float32, "count": torch.float32,
           "last_tick": torch.int32}


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """XLA:CPU's compiled executables hold memory maps of the worker
    process, which count against its map limit; the tier-1 run's
    JAX-heavy workers come close to it, so this file releases its own."""
    yield
    jax.clear_caches()


def _batch(rng, B, n_distinct, tick=0):
    pool_hi = rng.integers(0, 2**32, n_distinct, dtype=np.uint32)
    pool_lo = rng.integers(0, 2**32, n_distinct, dtype=np.uint32)
    pool_hi[0] = 0xFFFFFFFF          # keys in the sign bit's upper half
    pick = rng.integers(0, n_distinct, B)
    valid = rng.random(B) < 0.9
    upd = {"weight": rng.random(B).astype(np.float32),
           "count": np.ones(B, np.float32),
           "last_tick": np.full(B, tick, np.int32)}
    return pool_hi[pick], pool_lo[pick], upd, valid


def _j_insert(t, hi, lo, upd, valid, **kw):
    return js.insert_accumulate(
        t, jnp.asarray(hi), jnp.asarray(lo),
        {k: jnp.asarray(v) for k, v in upd.items()}, jnp.asarray(valid),
        modes=MODES, probe_rounds=kw.pop("probe_rounds", 16), **kw)


def _t_insert(t, hi, lo, upd, valid, **kw):
    return ts.insert_accumulate(
        t, from_np_u32(hi, "cpu"), from_np_u32(lo, "cpu"),
        {k: torch.tensor(v) for k, v in upd.items()}, torch.tensor(valid),
        modes=MODES, probe_rounds=kw.pop("probe_rounds", 16), **kw)


def _assert_tables_equal(jt, tt):
    np.testing.assert_array_equal(to_np_u32(tt.key_hi), np.asarray(jt.key_hi))
    np.testing.assert_array_equal(to_np_u32(tt.key_lo), np.asarray(jt.key_lo))
    for name in J_LANES:
        np.testing.assert_array_equal(tt.lanes[name].numpy(),
                                      np.asarray(jt.lanes[name]), err_msg=name)
    assert int(tt.n_dropped) == int(jt.n_dropped)


@pytest.mark.parametrize("C,B,n_distinct,rounds", [
    (1 << 12, 512, 40, 16),       # heavy duplication
    (64, 256, 200, 16),           # more keys than slots: full probes, drops
    (256, 300, 250, 4),           # short probe sequences: drops
    (1 << 20, 4096, 3000, 16),    # B > 1 << (31 - log2 C): no 31-bit packing
])
def test_insert_accumulate_matches_jax(C, B, n_distinct, rounds):
    rng = np.random.default_rng(C + B)
    jt = js.make_table(C, J_LANES)
    tt = ts.make_table(C, T_LANES, device="cpu")
    for step in range(3):
        hi, lo, upd, valid = _batch(rng, B, n_distinct, tick=step)
        jt = _j_insert(jt, hi, lo, upd, valid, probe_rounds=rounds)
        tt = _t_insert(tt, hi, lo, upd, valid, probe_rounds=rounds)
        _assert_tables_equal(jt, tt)
    if C == 64:
        assert int(tt.n_dropped) > 0


def test_lazy_rebase_insert_matches_jax():
    rng = np.random.default_rng(3)
    jt = js.make_table(1 << 10, J_LANES)
    tt = ts.make_table(1 << 10, T_LANES, device="cpu")
    for step, now in enumerate((0, 5, 13)):
        hi, lo, upd, valid = _batch(rng, 256, 100, tick=now)
        jt = _j_insert(jt, hi, lo, upd, valid, decay_cfg=JDecayConfig(),
                       now=jnp.int32(now))
        tt = _t_insert(tt, hi, lo, upd, valid, decay_cfg=DecayConfig(),
                       now=torch.tensor(now, dtype=torch.int32))
        np.testing.assert_array_equal(to_np_u32(tt.key_hi), np.asarray(jt.key_hi))
        np.testing.assert_allclose(tt.lanes["weight"].numpy(),
                                   np.asarray(jt.lanes["weight"]), rtol=1e-6)


@pytest.mark.parametrize("lazy", [False, True])
def test_lookup_matches_jax(lazy):
    rng = np.random.default_rng(5)
    C = 128
    jt, tt = js.make_table(C, J_LANES), ts.make_table(C, T_LANES,
                                                      device="cpu")
    hi, lo, upd, valid = _batch(rng, 400, 150)
    jt = _j_insert(jt, hi, lo, upd, valid)
    tt = _t_insert(tt, hi, lo, upd, valid)
    q_hi = np.concatenate([hi[:200], rng.integers(0, 2**32, 100, dtype=np.uint32),
                           np.zeros(4, np.uint32)])
    q_lo = np.concatenate([lo[:200], rng.integers(0, 2**32, 100, dtype=np.uint32),
                           np.zeros(4, np.uint32)])
    jkw = dict(decay_cfg=JDecayConfig(), now=jnp.int32(9)) if lazy else {}
    tkw = dict(decay_cfg=DecayConfig(),
               now=torch.tensor(9, dtype=torch.int32)) if lazy else {}
    jv, jf, jslot = js.lookup(jt, jnp.asarray(q_hi), jnp.asarray(q_lo), **jkw)
    tv, tf, tslot = ts.lookup(tt, from_np_u32(q_hi, "cpu"),
                              from_np_u32(q_lo, "cpu"), **tkw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    for name in J_LANES:
        np.testing.assert_allclose(tv[name].numpy(), np.asarray(jv[name]),
                                   rtol=1e-6)


def _sess_batch(rng, B, n_sessions, n_queries):
    s = rng.integers(1, 2**32, (2, n_sessions), dtype=np.uint32)
    q = rng.integers(1, 2**32, (2, n_queries), dtype=np.uint32)
    si, qi = rng.integers(0, n_sessions, B), rng.integers(0, n_queries, B)
    return (s[0][si], s[1][si], q[0][qi], q[1][qi],
            rng.integers(0, 3, B).astype(np.int32), rng.random(B) < 0.95)


@pytest.mark.parametrize("S,W,B,n_sessions", [
    (1 << 8, 4, 512, 20),     # long same-batch runs per session
    (64, 5, 300, 120),        # more sessions than rows: dropped sessions
])
def test_update_sessions_matches_jax(S, W, B, n_sessions):
    rng = np.random.default_rng(S + B)
    jt = js.make_session_table(S, W)
    tt = ts.make_session_table(S, W, device="cpu")
    for tick in range(3):
        sh, sl, qh, ql, src, valid = _sess_batch(rng, B, n_sessions, 30)
        jt, jp = js.update_sessions(
            jt, *(jnp.asarray(x) for x in (sh, sl, qh, ql, src)),
            jnp.int32(tick), jnp.asarray(valid))
        tt, tp = ts.update_sessions(
            tt, *(from_np_u32(x, "cpu") for x in (sh, sl, qh, ql)),
            torch.tensor(src), torch.tensor(tick, dtype=torch.int32),
            torch.tensor(valid))
        for f in ts.SessionTable._fields:
            a, b = getattr(tt, f).numpy(), np.asarray(getattr(jt, f))
            np.testing.assert_array_equal(a.view(b.dtype), b, err_msg=f)
        for f in ts.PairBatch._fields:
            a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
            np.testing.assert_array_equal(a.view(b.dtype), b, err_msg=f)
    jt = js.evict_sessions(jt, jnp.int32(40), 30)
    tt = ts.evict_sessions(tt, torch.tensor(40, dtype=torch.int32), 30)
    for f in ts.SessionTable._fields:
        a, b = getattr(tt, f).numpy(), np.asarray(getattr(jt, f))
        np.testing.assert_array_equal(a.view(b.dtype), b, err_msg=f)


def test_export_live_matches_jax():
    rng = np.random.default_rng(8)
    jt = js.make_table(256, J_LANES)
    tt = ts.make_table(256, T_LANES, device="cpu")
    hi, lo, upd, valid = _batch(rng, 200, 90)
    a = js.export_live(_j_insert(jt, hi, lo, upd, valid))
    b = ts.export_live(_t_insert(tt, hi, lo, upd, valid))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


MAX_MODES = (("weight", "add"), ("peak", "max"), ("hits", "max"),
             ("last_tick", "set"))
J_MAX_LANES = {"weight": jnp.float32, "peak": jnp.float32,
               "hits": jnp.int32, "last_tick": jnp.int32}
T_MAX_LANES = {"weight": torch.float32, "peak": torch.float32,
               "hits": torch.int32, "last_tick": torch.int32}


@pytest.mark.parametrize("C,B,n_distinct", [(1 << 10, 512, 40),
                                            (64, 256, 200)])
def test_insert_accumulate_max_lanes_match_jax(C, B, n_distinct):
    """MAX lanes: the segment max of each key's rows (negative values
    too), then the max of that and the slot's value; masked rows write
    nothing."""
    rng = np.random.default_rng(C + 7)
    jt, tt = js.make_table(C, J_MAX_LANES), ts.make_table(C, T_MAX_LANES,
                                                          device="cpu")
    for step in range(3):
        hi, lo, upd, valid = _batch(rng, B, n_distinct, tick=step)
        upd = {"weight": upd["weight"], "last_tick": upd["last_tick"],
               "peak": (rng.standard_normal(B) * 4).astype(np.float32),
               "hits": rng.integers(-50, 50, B).astype(np.int32)}
        jt = js.insert_accumulate(
            jt, jnp.asarray(hi), jnp.asarray(lo),
            {k: jnp.asarray(v) for k, v in upd.items()}, jnp.asarray(valid),
            modes=MAX_MODES)
        tt = ts.insert_accumulate(
            tt, from_np_u32(hi, "cpu"), from_np_u32(lo, "cpu"),
            {k: torch.tensor(v) for k, v in upd.items()}, torch.tensor(valid),
            modes=MAX_MODES)
        np.testing.assert_array_equal(to_np_u32(tt.key_hi),
                                      np.asarray(jt.key_hi))
        for name in J_MAX_LANES:
            np.testing.assert_array_equal(tt.lanes[name].numpy(),
                                          np.asarray(jt.lanes[name]),
                                          err_msg=name)
        assert int(tt.n_dropped) == int(jt.n_dropped)


def _twopass(mod, t, hi, lo, upd, valid, conv):
    return mod.insert_accumulate_twopass(
        t, conv(hi), conv(lo), {k: torch.tensor(v) if mod is ts else
                                jnp.asarray(v) for k, v in upd.items()},
        torch.tensor(valid) if mod is ts else jnp.asarray(valid),
        modes=MODES)


def _collision_heavy(rng, batch):
    keys = rng.integers(1, 200, size=256).astype(np.uint64) * 2654435761
    return keys, rng.random(256).astype(np.float32), rng.random(256) < 0.9


def _near_full(rng, batch):
    keys = (rng.integers(1, 400, size=300).astype(np.uint64)
            * np.uint64(0x9E3779B97F4A7C15)) | np.uint64(1)
    return keys, rng.random(300).astype(np.float32), np.ones(300, bool)


def _live_map(t):
    exp = ts.export_live(t)
    fps = (exp["key_hi"].astype(np.uint64) << np.uint64(32)) | exp["key_lo"]
    return {int(f): (float(w), float(c), int(lt)) for f, w, c, lt in
            zip(fps, exp["weight"], exp["count"], exp["last_tick"])}


@pytest.mark.parametrize("make,cap", [(_collision_heavy, 1 << 9),
                                      (_near_full, 1 << 8)],
                         ids=["collision-heavy", "near-full"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_accumulate_twopass_matches_jax(make, cap, seed):
    """The two-pass insert against JAX's, bit for bit and slot for slot,
    on ``tests/test_store_probe_parity.py``'s collision-heavy and
    near-full batches (the latter drops)."""
    from repro.core.hashing import split_fp
    rng = np.random.default_rng(seed)
    jt, tt = js.make_table(cap, J_LANES), ts.make_table(cap, T_LANES,
                                                        device="cpu")
    for batch in range(4):
        keys, w, valid = make(rng, batch)
        hi, lo = split_fp(keys)
        upd = {"weight": w, "count": np.ones(len(w), np.float32),
               "last_tick": np.full(len(w), batch, np.int32)}
        jt = _twopass(js, jt, hi, lo, upd, valid, jnp.asarray)
        tt = _twopass(ts, tt, hi, lo, upd, valid,
                      lambda a: from_np_u32(a, "cpu"))
        _assert_tables_equal(jt, tt)
    if make is _near_full:
        assert int(tt.n_dropped) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twopass_and_fused_insert_give_the_same_map(seed):
    """Where nothing drops the two probe strategies agree as a key-to-value
    map (slots may differ: the two-pass race lets the highest row win)."""
    from repro.core.hashing import split_fp
    rng = np.random.default_rng(seed)
    fused = ts.make_table(1 << 9, T_LANES, device="cpu")
    two = ts.make_table(1 << 9, T_LANES, device="cpu")
    for batch in range(4):
        keys, w, valid = _collision_heavy(rng, batch)
        hi, lo = split_fp(keys)
        upd = {"weight": w, "count": np.ones(256, np.float32),
               "last_tick": np.full(256, batch, np.int32)}
        fused = _t_insert(fused, hi, lo, upd, valid)
        two = _twopass(ts, two, hi, lo, upd, valid,
                       lambda a: from_np_u32(a, "cpu"))
    assert int(fused.n_dropped) == int(two.n_dropped) == 0
    a, b = _live_map(fused), _live_map(two)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k][0], b[k][0], rtol=1e-6)
        assert a[k][1:] == b[k][1:]

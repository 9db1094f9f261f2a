"""The PyTorch port's region layout (CPU) against the JAX package.

Inputs come from numpy seeds and go through both packages: the plain
versions of the two region kernels against the JAX Pallas kernels
(interpret mode) and the jnp paths, the region store's insert and sweeps
leaf by leaf, ``ranking_cycle_region`` under the suggestion contract, and
the whole engine with ``cooc_layout="region"`` on the ``tests/test_engine.py``
stream under both decay policies, compared under the contract in
``torch_parity.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ranking as jranking
from repro.core import stores as jstores
from repro.core.decay import DecayConfig as JDecayConfig
from repro.core.decay import region_decay_sweep as j_region_decay_sweep
from repro.core.decay import region_prune_sweep as j_region_prune_sweep
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SearchAssistanceEngine as JEngine
from repro.core.hashing import split_fp
from repro.core.ranking import RankConfig as JRankConfig
from repro.core.ranking import assoc_scores_jnp, combine_scores
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.stream import SyntheticStream as JStream
from repro.kernels import ops as jops
from repro.kernels.topk_select import region_rank as j_region_rank
from repro_torch.core import ranking as tranking
from repro_torch.core import stores as tstores
from repro_torch.core.decay import DecayConfig, region_decay_sweep, \
    region_prune_sweep
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.core.ranking import RankConfig
from repro_torch.data.stream import StreamConfig, SyntheticStream
from repro_torch.kernels import ref
from repro_torch.kernels.region_probe import chain_find
from repro_torch.kernels.topk_select import region_rank
from torch_parity import compare_states, compare_suggestions

Q_LANES_J = {"weight": jnp.float32, "count": jnp.float32,
             "last_tick": jnp.int32}
Q_LANES_T = {"weight": torch.float32, "count": torch.float32,
             "last_tick": torch.int32}
MODES = (("weight", "add"), ("count", "add"), ("last_tick", "set"))
COEFS = (1.0, 0.15, 0.02, 0.0)
GATES = dict(min_pair_weight=0.25, min_src_weight=0.5, min_pair_count=1.0)


def _t(a):
    a = np.asarray(a)
    return torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(t, like):
    a = t.numpy()
    return a.view(np.uint32) if np.asarray(like).dtype == np.uint32 else a


# ---------------------------------------------------------------------------
# Stores built by the JAX package, mirrored into the port
# ---------------------------------------------------------------------------

def _mk_qstore(rng, n_queries, qcap):
    """A JAX qstore holding ``n_queries`` random sources, and its fps."""
    q = jstores.make_table(qcap, Q_LANES_J)
    qf = np.unique((rng.integers(1, 2**63, n_queries).astype(np.uint64)) | 1)
    n = qf.shape[0]
    qh, ql = split_fp(qf)
    q = jstores.insert_accumulate(
        q, jnp.asarray(qh), jnp.asarray(ql),
        {"weight": jnp.asarray((rng.random(n) * 50 + 1).astype(np.float32)),
         "count": jnp.asarray(np.floor(rng.random(n) * 100 + 1)
                              .astype(np.float32)),
         "last_tick": jnp.zeros(n, jnp.int32)},
        jnp.ones(n, bool), modes=MODES)
    return q, qf


def _pair_events(rng, qf, n_pairs):
    a = qf[rng.integers(0, qf.shape[0], n_pairs)]
    b = qf[rng.integers(0, qf.shape[0], n_pairs)]
    return (*split_fp(a), *split_fp(b),
            (rng.random(n_pairs) * 5 + 0.5).astype(np.float32),
            np.floor(rng.random(n_pairs) * 20 + 1).astype(np.float32))


def _hash_to_torch(q):
    return tstores.HashTable(_t(q.key_hi), _t(q.key_lo),
                             {n: _t(v) for n, v in q.lanes.items()},
                             _t(q.n_dropped))


def _region_leaves(rt):
    """Every leaf of a region table (JAX or port) as numpy, u32 lanes as
    uint32, in field order with the lanes by name."""
    out = {}
    for name in ("key_hi", "key_lo", "chain_region", "chain_hi", "chain_lo",
                 "region_fill", "region_owner", "n_dropped"):
        x = getattr(rt, name)
        if isinstance(x, torch.Tensor):
            x = x.numpy()
            if name in ("key_hi", "key_lo", "chain_hi", "chain_lo"):
                x = x.view(np.uint32)
        out[name] = np.asarray(x)
    for name, lane in rt.lanes.items():
        out[name] = lane.numpy() if isinstance(lane, torch.Tensor) \
            else np.asarray(lane)
    return out


def _assert_region_equal(jrt, trt):
    """Keys, chains, fills, owners, n_dropped, ticks and counts exact;
    weights within rtol 1e-6 (the same f32 operations, different
    libraries)."""
    a, b = _region_leaves(jrt), _region_leaves(trt)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        if name == "weight":
            np.testing.assert_allclose(b[name], a[name], rtol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)


def _insert_both(q, jrt, trt, ev, tick=0, lazy=None):
    """The same pair events into the JAX and the port region store."""
    ah, al, bh, bl, pw, pc = ev
    n = ah.shape[0]
    jkw = tkw = {}
    if lazy is not None:
        jkw = dict(decay_cfg=JDecayConfig(policy="lazy", half_life_ticks=lazy),
                   now=jnp.int32(tick))
        tkw = dict(decay_cfg=DecayConfig(policy="lazy", half_life_ticks=lazy),
                   now=torch.tensor(tick, dtype=torch.int32))
    jrt = jstores.region_insert_accumulate(
        jrt, q, *(jnp.asarray(x) for x in (ah, al, bh, bl)),
        {"weight": jnp.asarray(pw), "count": jnp.asarray(pc),
         "last_tick": jnp.full(n, tick, jnp.int32)},
        jnp.ones(n, bool), modes=MODES, **jkw)
    trt = tstores.region_insert_accumulate(
        trt, _hash_to_torch(q), *(_t(x) for x in (ah, al, bh, bl)),
        {"weight": _t(pw), "count": _t(pc),
         "last_tick": torch.full((n,), tick, dtype=torch.int32)},
        torch.ones(n, dtype=torch.bool), modes=MODES, **tkw)
    return jrt, trt


def _mk_both(ccap, width, qcap, chain):
    return (jstores.make_region_table(ccap, width, qcap, chain, Q_LANES_J),
            tstores.make_region_table(ccap, width, qcap, chain, Q_LANES_T,
                                      device="cpu"))


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels and the jnp paths
# ---------------------------------------------------------------------------

def test_chain_find_plain_matches_jax():
    """The setup of ``test_region_layout.py::test_chain_find_kernel_matches_jnp``:
    a filled region store, the batch's keys and 32 absent ones."""
    rng = np.random.default_rng(13)
    qcap, ccap = 1 << 9, 1 << 11
    q, qf = _mk_qstore(rng, 80, qcap)
    jrt, trt = _mk_both(ccap, 8, qcap, 4)
    ev = _pair_events(rng, qf, 500)
    jrt, trt = _insert_both(q, jrt, trt, ev)
    ah, al, bh, bl, *_ = ev
    bh2 = np.concatenate([bh, bh[:32] ^ np.uint32(0xDEAD)])
    bl2 = np.concatenate([bl, bl[:32]])
    ah2 = np.concatenate([ah, ah[:32]])
    al2 = np.concatenate([al, al[:32]])
    _, src_found, qslot = jstores.lookup(q, jnp.asarray(ah2),
                                         jnp.asarray(al2))
    qslot_safe = jnp.where(src_found, qslot, 0)
    chain_ok = src_found & (jrt.chain_hi[qslot_safe] == jnp.asarray(ah2)) \
        & (jrt.chain_lo[qslot_safe] == jnp.asarray(al2)) \
        & (jrt.chain_region[qslot_safe, 0] >= 0)
    regs = jnp.where(chain_ok[:, None], jrt.chain_region[qslot_safe], -1)
    R, W = jrt.n_regions, jrt.width
    khi_r, klo_r = jrt.key_hi.reshape(R, W), jrt.key_lo.reshape(R, W)
    exp = np.asarray(jstores._chain_find_jnp(khi_r, klo_r, regs,
                                             jnp.asarray(bh2),
                                             jnp.asarray(bl2), chain_ok))
    ker = np.asarray(jops.chain_find(khi_r, klo_r, regs, jnp.asarray(bh2),
                                     jnp.asarray(bl2), chain_ok))
    args = [_t(np.asarray(x)) for x in (khi_r, klo_r, regs, bh2, bl2,
                                        chain_ok)]
    got = chain_find(*args).numpy()
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(got, ker)
    assert (got >= 0).sum() > 0 and (got[-32:] == -1).all()
    assert (np.asarray(regs)[:, 1] >= 0).any()        # chains deeper than 1


def _region_inputs(R, W, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.random(s) * 1.0).astype(np.float32)
    w_ab, c_ab = mk(R, W) * 5, np.floor(mk(R, W) * 20)
    w_a, w_b = mk(R) * 50, mk(R, W) * 50
    c_a = np.floor(mk(R) * 100) + 20
    c_b = np.maximum(c_ab, np.floor(mk(R, W) * 100))
    ok = rng.random((R, W)) < 0.8
    ok[0] = False                                  # a region with no pass
    lt = rng.integers(0, 20, (R, W)).astype(np.int32)
    return (w_ab, c_ab, w_a, w_b, c_a, c_b), ok, lt


def _not_tied(grid, vals, tol):
    """bool[R, k]: the k-th value is finite and lies more than ``tol``
    (relative) from every other value of its row's grid."""
    out = np.zeros(vals.shape, bool)
    for r, k in zip(*np.nonzero(np.isfinite(vals))):
        d = np.abs(grid[r] - vals[r, k])
        out[r, k] = (d <= tol * abs(vals[r, k]) + 1e-6).sum() == 1
    return out


# See test_torch_kernels.py: without the LLR lane the plain version meets
# rtol 1e-5 against XLA; with it only 5e-3 (XLA's CPU log ulps, amplified
# by LLR's cancellation; ROADMAP Queue 3).
@pytest.mark.parametrize("half_life", [None, 6.0])
@pytest.mark.parametrize("coefs,rtol,atol", [((1.0, 0.15, 0.0, 0.3), 1e-5, 1e-6),
                                              (COEFS, 5e-3, 1e-4)])
def test_region_rank_plain_matches_jax(half_life, coefs, rtol, atol):
    R, W, K = 48, 16, 8
    (w_ab, c_ab, w_a, w_b, c_a, c_b), ok, lt = _region_inputs(R, W, 3)
    tw, tc, now = 1e4, 2e4, 25.0
    vals, args, npass = (x.numpy() for x in region_rank(
        *(_t(x) for x in (w_ab, c_ab, w_a, w_b, c_a, c_b, ok, lt)),
        torch.tensor(tw), torch.tensor(tc), torch.tensor(now), k=K,
        coefs=coefs, half_life=half_life, **GATES))
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v)[:, None], (R, W))
    jl = [jnp.asarray(w_ab), jnp.asarray(c_ab), bc(w_a), jnp.asarray(w_b),
          bc(c_a), jnp.asarray(c_b)]
    kv, ka, kn = (np.asarray(x) for x in j_region_rank(
        *jl, jnp.asarray(ok), jnp.asarray(lt), jnp.float32(tw),
        jnp.float32(tc), jnp.float32(now), k=K, coefs=coefs,
        half_life=half_life, interpret=True, **GATES))
    # the jnp branch of ranking_cycle_region
    w_eff = jl[0] if half_life is None else jl[0] * jnp.exp2(
        -jnp.maximum(now - jnp.asarray(lt, jnp.float32), 0.0) / half_life)
    cfg = JRankConfig(coef_condprob=coefs[0], coef_pmi=coefs[1],
                      coef_llr=coefs[2], coef_chi2=coefs[3], **GATES)
    score = combine_scores(cfg, *assoc_scores_jnp(w_eff, *jl[1:],
                                                  jnp.float32(tw),
                                                  jnp.float32(tc)))
    gate = jnp.asarray(ok) & (w_eff >= GATES["min_pair_weight"]) \
        & (jl[1] >= GATES["min_pair_count"]) \
        & (jl[2] >= GATES["min_src_weight"])
    grid = np.asarray(jnp.where(gate, score, -jnp.inf))
    jv, ja = (np.asarray(x) for x in jax.lax.top_k(grid, K))
    jn = np.asarray(jnp.sum(gate.astype(jnp.int32), axis=1))
    for ev, ea, en in ((kv, ka, kn), (jv, ja, jn)):
        np.testing.assert_array_equal(npass, en)
        np.testing.assert_array_equal(np.isneginf(vals), np.isneginf(ev))
        fin = ~np.isneginf(ev)
        np.testing.assert_allclose(vals[fin], ev[fin], rtol=rtol, atol=atol)
        sep = _not_tied(grid, ev, 2 * rtol)
        np.testing.assert_array_equal(args[sep], ea[sep])
    assert (npass == 0).any() and np.isneginf(vals).any() \
        and (args[np.isneginf(vals)] == W).all()


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("lane", ["w_a", "w_b", "c_a", "c_b", "total_w",
                                  "total_c"])
def test_region_rank_nan_inf_marginals_match_pallas(lane, value):
    """NaN or +-inf in one marginal where c_ab > 0 (about 30% of those
    slots or rows, or the whole total): the plain version's values are NaN
    exactly where the Pallas kernel's are (a region whose gated grid holds
    a NaN gives NaN with the sentinel column in every round), npass and
    -inf equal, the rest as in the test above. ``lax.top_k`` in the jnp
    branch orders NaNs by sign, so it is held to the NaN-free rows only."""
    R, W, K = 48, 16, 8
    coefs, rtol, atol = (1.0, 0.15, 0.0, 0.3), 1e-5, 1e-6
    lanes, ok, lt = _region_inputs(R, W, 5)
    lanes = [x.copy() for x in lanes]
    tot = [np.float32(1e4), np.float32(2e4)]
    rng = np.random.default_rng(9)
    if lane.startswith("total"):
        tot[lane == "total_c"] = np.float32(value)
    elif lane in ("w_a", "c_a"):                   # one per region row
        x = lanes[2 if lane == "w_a" else 4]
        x[(lanes[1] > 0).any(1) & (rng.random(R) < 0.3)] = value
    else:
        x = lanes[3 if lane == "w_b" else 5]
        x[(lanes[1] > 0) & (rng.random((R, W)) < 0.3)] = value
    vals, args, npass = (x.numpy() for x in region_rank(
        *(_t(x) for x in (*lanes, ok, lt)), torch.tensor(tot[0]),
        torch.tensor(tot[1]), torch.tensor(25.0), k=K, coefs=coefs,
        half_life=None, **GATES))
    bc = lambda v: jnp.broadcast_to(jnp.asarray(v)[:, None], (R, W))
    jl = [jnp.asarray(lanes[0]), jnp.asarray(lanes[1]), bc(lanes[2]),
          jnp.asarray(lanes[3]), bc(lanes[4]), jnp.asarray(lanes[5])]
    kv, ka, kn = (np.asarray(x) for x in j_region_rank(
        *jl, jnp.asarray(ok), jnp.asarray(lt), jnp.float32(tot[0]),
        jnp.float32(tot[1]), jnp.float32(25.0), k=K, coefs=coefs,
        interpret=True, **GATES))
    np.testing.assert_array_equal(npass, kn)
    nan_row = np.isnan(kv).any(1)
    np.testing.assert_array_equal(np.isnan(vals), np.isnan(kv))
    assert np.isnan(vals[nan_row]).all() and (args[nan_row] == W).all()
    np.testing.assert_array_equal(np.isneginf(vals), np.isneginf(kv))
    fin = np.isfinite(kv)
    np.testing.assert_allclose(vals[fin], kv[fin], rtol=rtol, atol=atol)
    cfg = JRankConfig(coef_condprob=coefs[0], coef_pmi=coefs[1],
                      coef_llr=coefs[2], coef_chi2=coefs[3], **GATES)
    score = combine_scores(cfg, *assoc_scores_jnp(
        *jl, jnp.float32(tot[0]), jnp.float32(tot[1])))
    gate = jnp.asarray(ok) & (jl[0] >= GATES["min_pair_weight"]) \
        & (jl[1] >= GATES["min_pair_count"]) \
        & (jl[2] >= GATES["min_src_weight"])
    grid = np.asarray(jnp.where(gate, score, -jnp.inf))
    sep = _not_tied(grid, kv, 2 * rtol)
    np.testing.assert_array_equal(args[sep], ka[sep])
    jv, ja = (np.asarray(x) for x in jax.lax.top_k(grid[~nan_row], K))
    np.testing.assert_allclose(vals[~nan_row], jv, rtol=rtol, atol=atol)
    if lane in ("c_a", "c_b", "total_w", "total_c") and np.isnan(value):
        assert nan_row.any()


# ---------------------------------------------------------------------------
# Store: inserts, drops and sweeps leaf by leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lazy", [None, 8.0])
def test_region_insert_and_sweeps_match_jax(lazy):
    """Three batches of inserts (sweep or lazy rebase-on-write), then a
    decay sweep and a prune sweep that empty regions and orphan chains:
    every leaf equals the JAX one after each step."""
    rng = np.random.default_rng(3)
    qcap, ccap = 1 << 10, 1 << 12
    q, qf = _mk_qstore(rng, 120, qcap)
    jrt, trt = _mk_both(ccap, 16, qcap, 4)
    for tick in range(3):
        jrt, trt = _insert_both(q, jrt, trt, _pair_events(rng, qf, 700),
                                tick=tick * 3, lazy=lazy)
        _assert_region_equal(jrt, trt)
    # prune a third of the sources from the qstore, orphaning their chains
    gone = np.asarray(q.key_hi) != 0
    gone &= rng.random(gone.shape) < 0.33
    q = q._replace(key_hi=jnp.where(gone, 0, q.key_hi),
                   key_lo=jnp.where(gone, 0, q.key_lo))
    tq = _hash_to_torch(q)
    dcfg = dict(half_life_ticks=2.0, prune_threshold=1.0)
    jrt2, jl, jw, jr = j_region_decay_sweep(jrt, q, jnp.int32(3),
                                            cfg=JDecayConfig(**dcfg))
    trt2, tl, tw, tr = region_decay_sweep(trt, tq, 3,
                                          cfg=DecayConfig(**dcfg))
    _assert_region_equal(jrt2, trt2)
    assert int(tl) == int(jl) and int(tr) == int(jr) and int(tr) > 0
    assert int(trt2.free_regions()) > int(trt.free_regions())
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-5)
    lcfg = dict(policy="lazy", half_life_ticks=2.0, prune_threshold=1.0)
    jrt3, jl, jw, jr = j_region_prune_sweep(jrt, q, jnp.int32(8),
                                            cfg=JDecayConfig(**lcfg))
    trt3, tl, tw, tr = region_prune_sweep(trt, tq,
                                          torch.tensor(8, dtype=torch.int32),
                                          cfg=DecayConfig(**lcfg))
    _assert_region_equal(jrt3, trt3)
    assert int(tl) == int(jl) and int(tr) == int(jr)
    np.testing.assert_allclose(float(tw), float(jw), rtol=1e-5)
    # reinserts after the sweep reuse the compacted and freed space
    jrt4, trt4 = _insert_both(q, jrt2, trt2, _pair_events(rng, qf, 700),
                              tick=9, lazy=lazy)
    _assert_region_equal(jrt4, trt4)


@pytest.mark.parametrize("case", ["chain_full", "pool_full", "src_missing"])
def test_region_drops_match_jax(case):
    """The setups of ``test_region_layout.py`` for a full spill chain (14
    dsts, room for 8), an empty pool (12 sources, 4 regions) and sources
    absent from the qstore: the same drops, counted, and the same table."""
    rng = np.random.default_rng({"chain_full": 5, "pool_full": 8,
                                 "src_missing": 21}[case])
    if case == "chain_full":
        qcap, ccap, W, MC = 1 << 8, 1 << 8, 4, 2
        q, qf = _mk_qstore(rng, 40, qcap)
        src, dst = qf[:1].repeat(14), qf[1:15]
        expect = 14 - W * MC
    elif case == "pool_full":
        qcap, ccap, W, MC = 1 << 8, 1 << 6, 16, 2
        q, qf = _mk_qstore(rng, 32, qcap)
        src, dst = qf[:12], qf[12:24]
        expect = 12 - 4
    else:
        qcap, ccap, W, MC = 1 << 8, 1 << 8, 8, 2
        q, qf = _mk_qstore(rng, 16, qcap)
        src = (rng.integers(1, 2**63, 5).astype(np.uint64)) | 1
        dst = qf[:5]
        expect = 5
    n = src.shape[0]
    ev = (*split_fp(src), *split_fp(dst), np.ones(n, np.float32),
          np.ones(n, np.float32))
    jrt, trt = _insert_both(q, *_mk_both(ccap, W, qcap, MC), ev)
    _assert_region_equal(jrt, trt)
    assert int(trt.n_dropped) == expect
    # the same pairs again: placed ones accumulate, the rest drop again
    jrt, trt = _insert_both(q, jrt, trt, ev, tick=1)
    _assert_region_equal(jrt, trt)
    assert int(trt.n_dropped) == 2 * expect


def test_region_lookup_matches_jax():
    rng = np.random.default_rng(4)
    qcap, ccap = 1 << 10, 1 << 12
    q, qf = _mk_qstore(rng, 120, qcap)
    jrt, trt = _mk_both(ccap, 16, qcap, 4)
    ev = _pair_events(rng, qf, 700)
    jrt, trt = _insert_both(q, jrt, trt, ev, tick=2, lazy=8.0)
    ah, al, bh, bl, *_ = _pair_events(rng, qf, 300)
    ah, al = np.concatenate([ev[0][:300], ah]), np.concatenate([ev[1][:300], al])
    bh, bl = np.concatenate([ev[2][:300], bh]), np.concatenate([ev[3][:300], bl])
    jv, jf, js = jstores.region_lookup(
        jrt, q, *(jnp.asarray(x) for x in (ah, al, bh, bl)),
        decay_cfg=JDecayConfig(policy="lazy", half_life_ticks=8.0),
        now=jnp.int32(6))
    tv, tf, ts = tstores.region_lookup(
        trt, _hash_to_torch(q), *(_t(x) for x in (ah, al, bh, bl)),
        decay_cfg=DecayConfig(policy="lazy", half_life_ticks=8.0),
        now=torch.tensor(6, dtype=torch.int32))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tf.numpy()[:300].all() and not tf.numpy().all()
    for name in jv:
        np.testing.assert_allclose(tv[name].numpy(), np.asarray(jv[name]),
                                   rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# Ranking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,chain,top_k,max_sources,lazy", [
    (16, 4, 8, 0, False), (16, 4, 8, 0, True), (4, 1, 8, 0, False),
    (16, 4, 4, 8, False)])
def test_ranking_cycle_region_matches_jax(width, chain, top_k, max_sources,
                                          lazy):
    """Suggestions under the contract; ``n_rows`` and ``n_overflow`` exact.
    Cases: the default, the lazy policy (in-kernel half-life), a chain pool
    smaller than K (4 x 1 < 8: the merge pads), and a source cap that cuts
    (overflow counted)."""
    rng = np.random.default_rng(7)
    qcap, ccap = 1 << 10, 1 << 12
    q, qf = _mk_qstore(rng, 96, qcap)
    jrt, trt = _mk_both(ccap, width, qcap, chain)
    jrt, trt = _insert_both(q, jrt, trt, _pair_events(rng, qf, 600))
    jkw = tkw = {}
    if lazy:
        jkw = dict(decay_cfg=JDecayConfig(policy="lazy", half_life_ticks=6.0),
                   now=jnp.int32(5))
        tkw = dict(decay_cfg=DecayConfig(policy="lazy", half_life_ticks=6.0),
                   now=torch.tensor(5, dtype=torch.int32))
    jt = jranking.ranking_cycle_region(
        jrt, q, JRankConfig(top_k=top_k, max_sources=max_sources), **jkw)
    tt = tranking.ranking_cycle_region(
        trt, _hash_to_torch(q), RankConfig(top_k=top_k,
                                           max_sources=max_sources), **tkw)
    assert int(tt.n_rows) == int(jt.n_rows) > 0
    assert int(tt.n_overflow) == int(jt.n_overflow)
    assert (int(tt.n_overflow) > 0) == (max_sources > 0)
    compare_suggestions(jranking.suggestions_to_host(jt),
                        tranking.suggestions_to_host(tt))


# ---------------------------------------------------------------------------
# The engine on the tests/test_engine.py stream
# ---------------------------------------------------------------------------

CFG = dict(query_capacity=1 << 12, cooc_capacity=1 << 14,
           session_capacity=1 << 11, session_window=4, decay_every=4,
           rank_every=8, cooc_layout="region")
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
    for k in range(n_ticks):
        j.step(*jstream.gen_tick(k))
        t.step(*tstream.gen_tick(k))
    return j, t


@pytest.fixture(scope="module", params=["sweep", "lazy"])
def engines(request):
    return request.param, _run(lazy=request.param == "lazy")


def test_region_engine_state_matches_jax(engines):
    policy, (j, t) = engines
    a, b = j.state_arrays(), t.state_arrays()
    assert len(a) == len(b) == 27
    flips = compare_states(a, b, THRESH)
    print(f"prune flips vs JAX region engine, {policy} policy: {flips}")
    if policy == "sweep":
        assert flips == 0


def test_region_engine_suggestions_match_jax(engines):
    policy, (j, t) = engines
    assert t.n_rank_cycles == j.n_rank_cycles == 1
    assert (t.n_decay_cycles, t.n_prune_cycles) \
        == (j.n_decay_cycles, j.n_prune_cycles)
    assert t.last_maintenance.keys() == {
        k: float(v) for k, v in j.last_maintenance.items()}.keys()
    assert t.last_maintenance["c_free_regions"] \
        == j.last_maintenance["c_free_regions"] > 0
    share = compare_suggestions(j.suggestions, t.suggestions)
    print(f"top-3 identity agreement, {policy} policy: {share:.4f}")
    assert int(t.state.cooc.n_dropped) == 0


def test_cross_load_jax_region_state_into_port():
    """JAX region state at tick 5 -> load_state_arrays -> both step 4 more
    ticks and stay equal."""
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


def test_region_width_default_and_override():
    assert EngineConfig(cooc_layout="region", cooc_capacity=1 << 24).region_w \
        == 128
    cfg = dataclasses.replace(EngineConfig(**CFG), region_width=8)
    eng = SearchAssistanceEngine(cfg, device="cpu")
    assert eng.state.cooc.width == 8
    assert eng.state.cooc.n_regions == (1 << 14) // 8

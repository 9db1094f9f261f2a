"""The PyTorch port's hashing and input stream against the JAX package."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import hashing as jh
from repro.data.stream import EventSpec as JEventSpec
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.stream import SyntheticStream as JStream
from repro_torch.core import hashing as th
from repro_torch.data.stream import EventSpec, StreamConfig, SyntheticStream


def _u32(rng, n):
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_and_probe_hash_bit_identical(seed):
    rng = np.random.default_rng(seed)
    hi, lo = _u32(rng, 4096), _u32(rng, 4096)
    got = th._mix32(th.u32(th.from_np_u32(hi, "cpu"))).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jh._mix32(jnp.asarray(hi))))
    got = th.probe_hash(th.from_np_u32(hi, "cpu"), th.from_np_u32(lo, "cpu"))
    exp = np.asarray(jh.probe_hash(jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), exp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine_fp_device_bit_identical(seed):
    rng = np.random.default_rng(seed)
    a_hi, a_lo, b_hi, b_lo = (_u32(rng, 4096) for _ in range(4))
    got = th.combine_fp_device(*(th.from_np_u32(x, "cpu")
                                 for x in (a_hi, a_lo, b_hi, b_lo)))
    exp = jh.combine_fp_device(*(jnp.asarray(x) for x in (a_hi, a_lo, b_hi, b_lo)))
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(th.to_np_u32(g), np.asarray(e))
    np.testing.assert_array_equal(th.to_np_u32(got[1]),
                                  jh.combine_fp_np(a_hi, a_lo, b_hi, b_lo)[1])


def test_mul32_matches_wrapping_uint32_product():
    rng = np.random.default_rng(7)
    x = _u32(rng, 4096)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0xFFFFFFFF, 1):
        exp = (x.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = th.mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))


def test_host_fingerprints_identical():
    for s in ["", "steve jobs", "justin bieber", "ünïcödé", "a" * 100]:
        assert th.fingerprint(s) == jh.fingerprint(s)
    fps = np.array([th.fingerprint(f"q{i}") for i in range(100)], np.uint64)
    for a, b in zip(th.split_fp(fps), jh.split_fp(fps)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(th.join_fp(*th.split_fp(fps)), fps)


@pytest.mark.parametrize("events", [False, True])
def test_stream_ticks_identical(events):
    kw = dict(vocab_size=512, n_users=300, queries_per_tick=256,
              tweets_per_tick=32)
    ev_kw = dict(name="e", terms=("steve jobs", "apple", "ipad"), t_start=2,
                 ramp_ticks=2.0, peak_share=0.2)
    jcfg = JStreamConfig(**kw, events=(JEventSpec(**ev_kw),) if events else ())
    tcfg = StreamConfig(**kw, events=(EventSpec(**ev_kw),) if events else ())
    js, ts = JStream(jcfg, seed=3), SyntheticStream(tcfg, seed=3)
    assert js.vocab == ts.vocab
    for t in range(6):
        (jev, jtw), (tev, ttw) = js.gen_tick(t), ts.gen_tick(t)
        for a, b in zip((*jev, *jtw), (*tev, *ttw)):
            np.testing.assert_array_equal(a, b)


def test_combine_fp_bit_identical():
    rng = np.random.default_rng(4)
    vals = [0, 1, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15] + [
        int(x) for x in rng.integers(0, 2**63, 200, dtype=np.uint64)]
    for a, b in zip(vals, vals[::-1] + vals[:7]):
        assert th.combine_fp(a, b) == jh.combine_fp(a, b)
        assert th.combine_fp(b, a) == jh.combine_fp(b, a)
    assert th.combine_fp(0x9E3779B97F4A7C15, 0) == jh.combine_fp(
        0x9E3779B97F4A7C15, 0)

"""The PyTorch port's spelling job and count-min sketch (CPU) against the JAX
package.

Inputs are made with numpy from a seed and handed to both. The port's
``edit_distance_ref`` (the CUDA kernel's plain twin) must equal the JAX
reference and the Pallas kernel (interpret mode) bit for bit: the costs are
only ever added, in the same order, never multiplied. ``spelling_cycle``
must return the same dict, in the same order, as the JAX function. The
sketch's bucket hashes are bit-identical; its sums are exact for
integer-valued weights and within rtol 1e-6 otherwise (duplicate keys are
added in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sketch as jsk
from repro.core import spelling as js
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import SearchAssistanceEngine as JEngine
from repro.core.hashing import fingerprint, join_fp
from repro.core.stores import export_live as j_export_live
from repro.data.stream import StreamConfig as JStreamConfig
from repro.data.stream import SyntheticStream as JStream
from repro.kernels import ref as jref
from repro.kernels.edit_distance import edit_distance as j_edit_distance
from repro_torch.core import sketch as tsk
from repro_torch.core import spelling as ts
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.core.stores import export_live
from repro_torch.data.stream import StreamConfig, SyntheticStream
from repro_torch.kernels import ops as kops

CFG = dict(query_capacity=1 << 12, cooc_capacity=1 << 14,
           session_capacity=1 << 11, session_window=4, decay_every=4,
           rank_every=8)
STREAM = dict(vocab_size=256, n_users=150, queries_per_tick=128,
              tweets_per_tick=16, tweet_words=4, tweet_grams=6)
TILE = 128     # two tiles over the engine's live qstore
PLANTED = ["justin bieber", "justin beiber", "justin biber", "hadoop",
           "hadop", "big data", "lady gaga", "lady gagga", "world cup",
           "wrold cup"]
PLANTED_W = np.array([1000, 5, 3, 800, 4, 500, 900, 6, 700, 2], np.float64)


def _pairs(L, seed):
    """The pairs of tests/test_kernels.py's edit-distance property test,
    plus random pairs of every length 0..L over a small alphabet (many
    matches and transpositions)."""
    rng = np.random.default_rng(seed)
    rand = lambda n, k: "".join(chr(97 + c) for c in rng.integers(0, k, n))
    pairs = [(rand(rng.integers(0, 13), 6), rand(rng.integers(0, 13), 6))
             for _ in range(48)]
    pairs += [("justin bieber", "justin beiber"), ("same", "same"), ("", "")]
    pairs += [(rand(rng.integers(0, L + 1), 3),
               rand(rng.integers(0, L + 1), 3)) for _ in range(80)]
    pairs += [(rand(L, 2), rand(L, 2)), (rand(L, 3), ""), ("", rand(L, 3))]
    A, B = zip(*pairs)
    return js.encode_strings(list(A), L) + js.encode_strings(list(B), L)


def _torch_ed(ac, al, bc, bl, fc):
    return kops.edit_distance(torch.from_numpy(ac), torch.from_numpy(al),
                              torch.from_numpy(bc), torch.from_numpy(bl),
                              first_char_cost=fc).numpy()


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("fc", [1.0, 1.5, 1.3])
@pytest.mark.parametrize("L", [16, 24])
def test_edit_distance_plain_matches_jax_reference(L, fc):
    ac, al, bc, bl = _pairs(L, seed=L)
    exp = jref.edit_distance_ref(jnp.asarray(ac), jnp.asarray(al),
                                 jnp.asarray(bc), jnp.asarray(bl), fc)
    np.testing.assert_array_equal(_bits(_torch_ed(ac, al, bc, bl, fc)),
                                  _bits(exp))


@pytest.mark.parametrize("fc", [1.0, 1.5])
@pytest.mark.parametrize("L", [16, 24])
def test_edit_distance_plain_matches_pallas(L, fc):
    ac, al, bc, bl = (x[-64:] for x in _pairs(L, seed=L + 1))
    exp = j_edit_distance(jnp.asarray(ac), jnp.asarray(al), jnp.asarray(bc),
                          jnp.asarray(bl), first_char_cost=fc, interpret=True)
    np.testing.assert_array_equal(_bits(_torch_ed(ac, al, bc, bl, fc)),
                                  _bits(exp))


def _same_items(exp, got):
    assert list(got.items()) == list(exp.items())


def test_spelling_matches_jax_on_planted_misspellings():
    fps = np.array([fingerprint(t) for t in PLANTED], np.uint64)
    exp = js.spelling_cycle(fps, PLANTED, PLANTED_W,
                            js.SpellConfig(freq_boost=3.0))
    got = ts.spelling_cycle(fps, PLANTED, PLANTED_W,
                            ts.SpellConfig(freq_boost=3.0), device="cpu")
    _same_items(exp, got)
    assert got[fingerprint("wrold cup")][0] == fingerprint("world cup")


@pytest.fixture(scope="module")
def qstore_job():
    """The live qstore of the JAX engine and of the port's after the same 5
    ticks of the tests/test_engine.py stream, with the JAX job's result."""
    jstream = JStream(JStreamConfig(**STREAM), seed=11)
    tstream = SyntheticStream(StreamConfig(**STREAM), seed=11)
    j = JEngine(JEngineConfig(**CFG))
    t = SearchAssistanceEngine(EngineConfig(**CFG), device="cpu")
    for k in range(5):
        j.step(*jstream.gen_tick(k))
        t.step(*tstream.gen_tick(k))
    je, te = j_export_live(j.state.qstore), export_live(t.state.qstore)
    for name in ("key_hi", "key_lo", "weight"):
        np.testing.assert_array_equal(np.asarray(je[name]), te[name])
    fps = join_fp(te["key_hi"], te["key_lo"])
    texts = [tstream.tok.text(int(f)) for f in fps]
    exp = js.spelling_cycle(fps, [jstream.tok.text(int(f)) for f in fps],
                            np.asarray(je["weight"]),
                            js.SpellConfig(tile=TILE, use_kernel=False))
    return fps, texts, te["weight"], exp


@pytest.mark.parametrize("block_cells", [ts.BLOCK_CELLS, 1 << 12])
def test_spelling_matches_jax_on_engine_qstore(qstore_job, block_cells,
                                               monkeypatch):
    monkeypatch.setattr(ts, "BLOCK_CELLS", block_cells)
    fps, texts, weights, exp = qstore_job
    assert weights.dtype == np.float32 and len(fps) > TILE    # two tiles
    stats = {}
    got = ts.spelling_cycle(fps, texts, weights, ts.SpellConfig(tile=TILE),
                            device="cpu", stats=stats)
    assert exp, "the stream's planted misspellings give corrections"
    _same_items(exp, got)
    assert stats["sources"] == len(fps) and stats["pairs"] > 0
    assert (stats["blocks"] > 1) == (block_cells == 1 << 12)


@pytest.mark.parametrize("tile,dup_fps", [(256, False), (16, False),
                                          (16, True)])
def test_spelling_matches_jax_with_tied_weights(tile, dup_fps, monkeypatch):
    """Few distinct weights (the unstable argsort decides ties), several
    tiles, and optionally repeated fingerprints (a key keeps its first
    place in the dict and takes the last value assigned)."""
    rng = np.random.default_rng(7)
    base = ["hadoop", "lady gaga", "world cup", "big data", "bieber"]
    texts = []
    for _ in range(32):
        w = list(base[rng.integers(len(base))])
        for _ in range(rng.integers(0, 3)):
            w[rng.integers(1, len(w))] = "xyz"[rng.integers(3)]
        texts.append("".join(w))
    weights = rng.choice([1.0, 3.0, 9.0, 27.0], len(texts)).astype(np.float32)
    fps = (rng.integers(1, 9, len(texts)) if dup_fps
           else np.arange(1, len(texts) + 1)).astype(np.uint64)
    exp = js.spelling_cycle(fps, texts, weights,
                            js.SpellConfig(tile=tile, use_kernel=False))
    monkeypatch.setattr(ts, "BLOCK_CELLS", 256)
    got = ts.spelling_cycle(fps, texts, weights, ts.SpellConfig(tile=tile),
                            device="cpu")
    assert exp
    _same_items(exp, got)


def test_spelling_config_matches_jax_minus_use_kernel():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(js.SpellConfig)}
    assert jf.pop("use_kernel") is True
    assert {f.name: f.default
            for f in dataclasses.fields(ts.SpellConfig)} == jf
    assert ts.normalize_query("@Obama  #News") == js.normalize_query(
        "@Obama  #News")


def _keys(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint32), \
        rng.integers(0, 2**32, n, dtype=np.uint32)


def test_sketch_rows_match_jax():
    rng = np.random.default_rng(3)
    hi, lo = _keys(rng, 4096)
    exp = jsk._rows(8, 1 << 12, jnp.asarray(hi), jnp.asarray(lo))
    got = tsk._rows(8, 1 << 12, torch.from_numpy(hi.view(np.int32)),
                    torch.from_numpy(lo.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


@pytest.mark.parametrize("integer_weights", [True, False])
def test_sketch_update_query_decay_match_jax(integer_weights):
    rng = np.random.default_rng(4)
    hi, lo = _keys(rng, 300)
    hi, lo = np.concatenate([hi, hi[:200]]), np.concatenate([lo, lo[:200]])
    w = rng.random(500).astype(np.float32) * 8
    if integer_weights:
        w = np.floor(w)
    valid = rng.random(500) < 0.9
    j = jsk.make_sketch(depth=4, width=1 << 8)
    j = jsk.sketch_decay(jsk.sketch_update(
        j, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w),
        jnp.asarray(valid)), 0.5)
    th, tl = (torch.from_numpy(x.view(np.int32)) for x in (hi, lo))
    t = tsk.make_sketch(depth=4, width=1 << 8, device="cpu")
    t2 = tsk.sketch_decay(tsk.sketch_update(
        t, th, tl, torch.from_numpy(w), torch.from_numpy(valid)), 0.5)
    assert float(t.table.abs().sum()) == 0.0        # the input is untouched
    exp = np.asarray(jsk.sketch_query(j, jnp.asarray(hi), jnp.asarray(lo)))
    got = tsk.sketch_query(t2, th, tl).numpy()
    if integer_weights:
        np.testing.assert_array_equal(got, exp)
        np.testing.assert_array_equal(t2.table.numpy(), np.asarray(j.table))
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-6)
        np.testing.assert_allclose(t2.table.numpy(), np.asarray(j.table),
                                   rtol=1e-6)

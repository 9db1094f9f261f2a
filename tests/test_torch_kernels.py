"""The PyTorch port's kernels: plain versions against the JAX Pallas kernels
(interpret mode, as ``tests/test_kernels.py`` runs them) and the dispatch
policy. The CUDA kernels themselves are tested in ``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.assoc_score import assoc_score as j_assoc_score
from repro.kernels.decay_prune import decay_prune_multi as j_decay_prune_multi
from repro.kernels.topk_select import bucket_topk as j_bucket_topk
from repro.kernels.topk_select import score_gate as j_score_gate
from repro_torch import kernels as tk
from repro_torch.kernels import build, ops
from repro_torch.kernels.assoc_score import assoc_score
from repro_torch.kernels.decay_prune import decay_prune_multi
from repro_torch.kernels.region_probe import chain_find
from repro_torch.kernels.topk_select import bucket_topk, region_rank, \
    score_gate

COEFS = (1.0, 0.15, 0.02, 0.0)
GATES = dict(min_pair_weight=0.25, min_src_weight=0.5, min_pair_count=1.0)


def _table(C, seed):
    rng = np.random.default_rng(seed)
    kh = rng.integers(0, 2**32, C, dtype=np.uint32)
    kl = rng.integers(0, 2**32, C, dtype=np.uint32)
    dead = rng.random(C) < 0.4
    kh[dead] = 0
    kl[dead] = 0
    w = (rng.random(C) * 3).astype(np.float32)
    w2 = (rng.random(C) * 3).astype(np.float32)
    aux = (np.floor(rng.random(C) * 9).astype(np.float32),          # count
           rng.integers(0, 50, C).astype(np.int32),                   # tick
           rng.integers(0, 2**32, C, dtype=np.uint32))                # fp
    return kh, kl, (w, w2), aux


def _t(a, device="cpu"):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def _np(t, like):
    a = t.cpu().numpy()
    return a.view(np.uint32) if like.dtype == np.uint32 else a


@pytest.mark.parametrize("C", [1024, 4096])
@pytest.mark.parametrize("factor,thresh", [(0.5, 0.1), (0.99, 0.0), (0.1, 2.0)])
def test_decay_prune_multi_plain_matches_pallas(C, factor, thresh):
    kh, kl, ws, aux = _table(C, C + int(factor * 100))
    got = decay_prune_multi(_t(kh), _t(kl), [_t(w) for w in ws],
                            [_t(a) for a in aux],
                            torch.tensor(factor, dtype=torch.float32), thresh)
    exp = j_decay_prune_multi(jnp.asarray(kh), jnp.asarray(kl),
                              tuple(jnp.asarray(w) for w in ws),
                              tuple(jnp.asarray(a) for a in aux),
                              jnp.float32(factor), jnp.float32(thresh),
                              interpret=True)
    np.testing.assert_array_equal(_np(got[0], kh), np.asarray(exp[0]))
    np.testing.assert_array_equal(_np(got[1], kl), np.asarray(exp[1]))
    for g, e in zip(got[2], exp[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    for g, e, a in zip(got[3], exp[3], aux):
        np.testing.assert_array_equal(_np(g, a), np.asarray(e))
    assert int(got[4]) == int(exp[4])
    np.testing.assert_allclose(float(got[5]), float(exp[5]), rtol=1e-5)


def _score_inputs(C, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: (rng.random(C) * s).astype(np.float32)
    w_ab, c_ab = mk(5), np.floor(mk(20))
    w_a, w_b = mk(50), mk(50)
    c_a = np.maximum(c_ab, np.floor(mk(100)))
    c_b = np.maximum(c_ab, np.floor(mk(100)))
    ok = rng.random(C) < 0.8
    lt = rng.integers(0, 20, C).astype(np.int32)
    return (w_ab, c_ab, w_a, w_b, c_a, c_b), ok, lt


# Without the LLR lane the plain version meets rtol 1e-5 against the Pallas
# kernel. With it, it cannot on the CPU: XLA's f32 log differs from the
# correctly rounded value by one ulp on about 1% of inputs (torch's almost
# never), and LLR's sum of x*log(x) terms of magnitude ~n*log(n) cancels,
# which turns those ulps into up to ~3e-3 relative score. That case keeps
# the bound ``tests/test_kernels.py`` holds the Pallas kernel to against
# its own jnp oracle (rtol 5e-3, atol 1e-4), and the LLR lane itself is
# held to the f32 rounding bound of its terms.
@pytest.mark.parametrize("C", [1024, 8192])
@pytest.mark.parametrize("half_life", [None, 6.0])
@pytest.mark.parametrize("coefs,rtol,atol", [((1.0, 0.15, 0.0, 0.3), 1e-5, 1e-6),
                                              (COEFS, 5e-3, 1e-4)])
def test_score_gate_plain_matches_pallas(C, half_life, coefs, rtol, atol):
    lanes, ok, lt = _score_inputs(C, C + int(half_life or 0))
    tw, tc, now = 1e4, 2e4, 25.0
    got = score_gate(*[_t(x) for x in lanes], _t(ok), _t(lt),
                     torch.tensor(tw, dtype=torch.float32),
                     torch.tensor(tc, dtype=torch.float32),
                     torch.tensor(now, dtype=torch.float32), coefs=coefs,
                     half_life=half_life, **GATES).numpy()
    exp = np.asarray(j_score_gate(
        *[jnp.asarray(x) for x in lanes], jnp.asarray(ok, jnp.float32),
        jnp.asarray(lt), jnp.float32(tw), jnp.float32(tc), jnp.float32(now),
        coefs=coefs, half_life=half_life, interpret=True, **GATES))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(exp))
    fin = ~np.isneginf(exp)
    assert fin.any() and (~fin).any()
    np.testing.assert_allclose(got[fin], exp[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("C", [1024, 8192])
@pytest.mark.parametrize("coefs,rtol,atol", [((1.0, 0.15, 0.0, 0.3), 1e-5, 1e-6),
                                              (COEFS, 5e-3, 1e-4)])
def test_assoc_score_plain_matches_pallas(C, coefs, rtol, atol):
    """The stand-alone kernel's plain route (``score_body``) against the
    Pallas ``assoc_score``, at the tolerances of the score_gate test."""
    lanes, _, _ = _score_inputs(C, C + 3)
    tw, tc = 1e4, 2e4
    got = assoc_score(*[_t(x) for x in lanes], tw, tc, coefs=coefs).numpy()
    exp = np.asarray(j_assoc_score(*[jnp.asarray(x) for x in lanes],
                                   jnp.float32(tw), jnp.float32(tc),
                                   coefs=coefs, interpret=True))
    np.testing.assert_allclose(got, exp, rtol=rtol, atol=atol)


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("lane", ["w_a", "w_b", "c_a", "c_b", "total_w",
                                  "total_c"])
def test_score_body_nan_inf_marginals_match_jax(lane, value):
    """NaN and +-inf in one marginal of slots with c_ab > 0 (about 30% of
    them, or the whole total): the twin ``score_body`` is NaN exactly where
    the JAX ``score_body`` is, and agrees elsewhere at the score_gate test's
    tolerance without the LLR weight (0 x a NaN lane is still NaN, so LLR's
    NaNs show). The CUDA body is held to the twin on the card."""
    from repro.kernels.assoc_score import score_body as j_score_body
    from repro_torch.kernels.assoc_score import score_body
    lanes, _, _ = _score_inputs(4096, 21)
    lanes = [x.copy() for x in lanes]
    tot = [np.float32(1e4), np.float32(2e4)]
    if lane.startswith("total"):
        tot[lane == "total_c"] = np.float32(value)
    else:
        x = lanes[("w_a", "w_b", "c_a", "c_b").index(lane) + 2]
        rng = np.random.default_rng(4)
        x[(lanes[1] > 0) & (rng.random(x.shape[0]) < 0.3)] = value
    coefs = (1.0, 0.15, 0.0, 0.3)
    got = score_body(*[_t(x) for x in lanes],
                     *[torch.tensor(x) for x in tot], coefs).numpy()
    exp = np.asarray(j_score_body(*[jnp.asarray(x) for x in lanes],
                                  *[jnp.float32(x) for x in tot], coefs))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(exp))
    fin = ~np.isnan(exp)
    np.testing.assert_allclose(got[fin], exp[fin], rtol=1e-5, atol=1e-6)
    if lane in ("c_a", "c_b", "total_w", "total_c") and np.isnan(value):
        assert np.isnan(exp).any()


def test_assoc_lanes_match_jnp_reference():
    """condprob, pmi and chi2 within rtol 1e-5 of the JAX lanes; LLR within
    the f32 rounding bound of its nine x*log(x) terms."""
    from repro.core.ranking import assoc_scores_jnp
    from repro_torch.core.ranking import assoc_scores_jnp as t_assoc
    lanes, _, _ = _score_inputs(8192, 4)
    tw, tc = np.float32(1e4), np.float32(2e4)
    exp = assoc_scores_jnp(*[jnp.asarray(x) for x in lanes], tw, tc)
    got = t_assoc(*[_t(x) for x in lanes], torch.tensor(tw), torch.tensor(tc))
    for i in (0, 1, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(exp[i]),
                                   rtol=1e-5, atol=1e-6)
    n = lanes[0] * 0 + tc                      # the largest table total
    bound = 2 * 9 * 2 * np.finfo(np.float32).eps * n * np.log(n)
    assert (np.abs(got[2].numpy() - np.asarray(exp[2])) <= bound).all()


def _grid(R, L, seed):
    rng = np.random.default_rng(seed)
    g = np.floor(rng.random((R, L)).astype(np.float32) * 20)  # many ties
    g[rng.random((R, L)) < 0.3] = -np.inf
    g[0, :] = -np.inf
    g[-1, : max(L - 2, 0)] = -np.inf                           # < k finite
    return g


@pytest.mark.parametrize("shape,k", [((256, 64), 8), ((1000, 32), 4),
                                     ((7, 130), 8), ((5, 3), 6)])
def test_bucket_topk_plain_matches_pallas(shape, k):
    g = _grid(*shape, seed=shape[0])
    vals, args = bucket_topk(torch.tensor(g), k)
    jv, ja = j_bucket_topk(jnp.asarray(g), k, interpret=True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    fin = ~np.isneginf(np.asarray(jv))
    np.testing.assert_array_equal(args.numpy()[fin], np.asarray(ja)[fin])
    assert (args.numpy()[~fin] == shape[1]).all()   # sentinel column L


def _nan_grid(R, L, seed):
    """``_grid`` with NaN of either sign in a third of the rows: one NaN,
    a few, or a whole row."""
    g = _grid(R, L, seed)
    rng = np.random.default_rng(seed + 1)
    rows = np.nonzero(rng.random(R) < 0.33)[0]
    for i, r in enumerate(rows):
        n = (1, 3, L)[i % 3]
        cols = rng.choice(L, min(n, L), replace=False)
        g[r, cols] = rng.choice(np.array([np.nan, -np.nan], np.float32),
                                len(cols))
    return g, np.isnan(g).any(1)


@pytest.mark.parametrize("shape,k", [((256, 64), 8), ((300, 64), 33),
                                     ((7, 130), 8), ((5, 3), 6)])
def test_bucket_topk_nan_rows_match_pallas(shape, k):
    """A row that holds a NaN: the plain version gives NaN with the
    sentinel column in every round, as the Pallas kernel does (its row max
    is NaN, which no element equals). ``lax.top_k`` (JAX's
    ``ref.bucket_topk_ref``) orders NaNs by sign instead, so it is held to
    the rows without NaN only; the parity contract records the split."""
    from repro.kernels.ref import bucket_topk_ref as j_bucket_topk_ref
    g, nan_row = _nan_grid(*shape, seed=shape[0] + k)
    assert nan_row.any() and not nan_row.all()
    vals, args = (x.numpy() for x in bucket_topk(torch.tensor(g), k))
    jv, ja = (np.asarray(x) for x in j_bucket_topk(jnp.asarray(g), k,
                                                   interpret=True))
    np.testing.assert_array_equal(np.isnan(vals), np.isnan(jv))
    assert np.isnan(vals[nan_row]).all() and (args[nan_row] == shape[1]).all()
    fin = ~np.isnan(jv) & ~np.isneginf(jv)
    np.testing.assert_array_equal(vals[~np.isnan(jv)], jv[~np.isnan(jv)])
    np.testing.assert_array_equal(args[fin], ja[fin])
    assert (args[~fin] == shape[1]).all()          # sentinel column L
    keep = min(k, shape[1])
    rv, ra = (np.asarray(x) for x in j_bucket_topk_ref(
        jnp.asarray(g[~nan_row]), keep))
    np.testing.assert_array_equal(vals[~nan_row][:, :keep], rv)
    rfin = ~np.isneginf(rv)
    np.testing.assert_array_equal(args[~nan_row][:, :keep][rfin], ra[rfin])


def test_bucket_topk_ties_resolve_to_lowest_column():
    g = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0] * 5])
    vals, args = bucket_topk(g, 4)
    assert args.tolist() == [[1, 2, 4, 3], [0, 1, 2, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0], [0.0] * 4]


def test_cpu_route_uses_plain_version_and_counts_nothing():
    tk.reset_launches()
    kh, kl, ws, aux = _table(64, 0)
    decay_prune_multi(_t(kh), _t(kl), [_t(ws[0])], [], 0.5, 0.1)
    bucket_topk(torch.zeros((4, 8)), 2)
    z = torch.zeros((4, 8))
    one = torch.tensor(1.0)
    region_rank(z, z, z[:, 0], z, z[:, 0], z, z > 0, None, one, one, None,
                k=2, coefs=COEFS, **GATES)
    chain_find(z.int(), z.int(), torch.full((3, 2), -1, dtype=torch.int32),
               torch.ones(3, dtype=torch.int32),
               torch.ones(3, dtype=torch.int32), torch.ones(3, dtype=bool))
    assoc_score(*([z[0]] * 6), 1.0, 1.0, coefs=COEFS)
    chars = torch.zeros((3, 24), dtype=torch.uint8)
    lens = torch.ones(3, dtype=torch.int32)
    assert ops.edit_distance(chars, lens, chars, lens).tolist() == [0.0] * 3
    q = torch.ones((1, 4, 8, 16))
    kv = torch.ones((1, 2, 8, 16))
    assert torch.equal(ops.flash_attention(q, kv, kv, True, 4), q)
    assert tk.LAUNCHES == {name: 0 for name in tk.KERNELS}
    assert tk.route(torch.zeros(1)) == "plain"
    with pytest.raises(RuntimeError):
        tk.route(torch.zeros(1, device="meta"))


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_kernel_sources_and_library_names():
    stems = {p.stem for p in build.sources()}
    assert stems == {"decay_prune", "score_gate", "bucket_topk", "chain_find",
                     "region_rank", "assoc_score", "edit_distance",
                     "flash_attention"}
    names = {build.library_path(p).name for p in build.sources()}
    assert len(names) == 8

"""The PyTorch port on a CUDA card: each CUDA kernel against its plain
version, the engine on the card against the engine on the CPU under both
cooc layouts, bit-identical state across two runs on the card, overload
control's fused flushes against per-tick steps on the card, a compaction
fold on the card against the same fold on the CPU, the LM's SMOKE
models (dense and MoE) and the MoE layer on the card against the CPU,
the autotuner on the card, the engine on the card against the port's
reference engine, the recsys and GAT SMOKE models, JAX's gather rules
and the top-k tie order on the card against the CPU, and training:
``flash_attention``'s gradients through the kernel forward against the
twin's, and SMOKE train steps on the card against the CPU.

Every test takes the ``cuda`` fixture, which skips it where there is no
card (the CPU test run). This file imports neither JAX nor the JAX package,
so it runs on a machine with a card and no JAX:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core import sketch as tsk
from repro_torch.core import spelling
from repro_torch.core.decay import DecayConfig
from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
from repro_torch.core.hashing import fingerprint, join_fp
from repro_torch.core.spelling import encode_strings, spelling_cycle
from repro_torch.core.stores import export_live
from repro_torch.data.stream import StreamConfig, SyntheticStream
from repro_torch.kernels import edit_distance as ked
from repro_torch.kernels import region_probe as kprobe
from repro_torch.kernels import topk_select as ktk
from repro_torch.kernels import ref
from repro_torch.kernels.assoc_score import assoc_score, score_body
from repro_torch.kernels.decay_prune import decay_prune_multi
from repro_torch.kernels.edit_distance import edit_distance
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.region_probe import chain_find
from repro_torch.kernels.topk_select import bucket_topk, decay_exp2, \
    region_rank, score_gate

COEFS = (1.0, 0.15, 0.02, 0.0)
GATES = dict(min_pair_weight=0.25, min_src_weight=0.5, min_pair_count=1.0)
CFG = dict(query_capacity=1 << 12, cooc_capacity=1 << 14,
           session_capacity=1 << 11, session_window=4, decay_every=4,
           rank_every=8)
STREAM = dict(vocab_size=256, n_users=150, queries_per_tick=128,
              tweets_per_tick=16, tweet_words=4, tweet_grams=6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, device):
    a = np.asarray(a)
    return torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a,
                        device=device)


@pytest.mark.parametrize("C", [1000, 1 << 16])
def test_decay_prune_multi_cuda_matches_plain(cuda, C):
    rng = np.random.default_rng(C)
    kh = rng.integers(0, 2**32, C, dtype=np.uint32)
    kl = rng.integers(0, 2**32, C, dtype=np.uint32)
    kh[rng.random(C) < 0.4] = 0
    kl[kh == 0] = 0
    ws = [(rng.random(C) * 3).astype(np.float32)]
    aux = [np.floor(rng.random(C) * 9).astype(np.float32),
           rng.integers(0, 50, C).astype(np.int32),
           rng.integers(0, 2**32, C, dtype=np.uint32)]
    args = [_t(kh, cuda), _t(kl, cuda), [_t(w, cuda) for w in ws],
            [_t(a, cuda) for a in aux]]
    before = tk.LAUNCHES["decay_prune_multi"]
    got = decay_prune_multi(*args, 0.8, 0.3)
    assert tk.LAUNCHES["decay_prune_multi"] == before + 1
    exp = ref.decay_prune_multi_ref(*args, 0.8, 0.3)
    for g, e in zip((got[0], got[1], *got[2], *got[3]),
                    (exp[0], exp[1], *exp[2], *exp[3])):
        assert torch.equal(g, e)
    assert int(got[4]) == int(exp[4])
    with pytest.raises(ValueError, match="one weight lane"):
        decay_prune_multi(args[0], args[1], args[2] * 2, args[3], 0.8, 0.3)


def _score_lanes(C, seed, live):
    """Six score lanes, base gate and last_tick as numpy: ~71% of slots pass
    at ``live`` 0.8 (the synthetic lanes), ~1.4% at 0.014 (a store)."""
    rng = np.random.default_rng(seed)
    mk = lambda s: (rng.random(C) * s).astype(np.float32)
    w_ab, c_ab = mk(5), np.floor(mk(20))
    w_a, w_b = mk(50), mk(50)
    c_a = np.maximum(c_ab, np.floor(mk(100)))
    c_b = np.maximum(c_ab, np.floor(mk(100)))
    ok = rng.random(C) < live
    c_ab[~ok & (rng.random(C) < 0.9)] = 0.0       # dead slots: no count
    lt = rng.integers(0, 20, C).astype(np.int32)
    return (w_ab, c_ab, w_a, w_b, c_a, c_b), ok, lt


def _on_card(x, cuda, offset):
    """``x`` on the card; at ``offset`` 1 a view one element into a buffer,
    so its base is not 16-byte aligned."""
    x = _t(x, cuda)
    if not offset:
        return x
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    buf[1:] = x
    return buf[1:]


def _assert_gated_equal(got, exp, w_eff):
    """Bit-equal wherever the gates agree; the lazy gate may flip only
    where w_eff sits within 1 ulp of min_pair_weight."""
    flips = torch.isneginf(got) != torch.isneginf(exp)
    near = (w_eff - GATES["min_pair_weight"]).abs() <= 2.0 ** -23 * 0.25
    assert bool((~flips | near).all())
    assert torch.equal(got[~flips].view(torch.int32),
                       exp[~flips].view(torch.int32))


@pytest.mark.parametrize("half_life", [None, 6.0])
def test_score_gate_cuda_matches_plain(cuda, half_life):
    rng = np.random.default_rng(9)
    C = 1 << 16
    mk = lambda s: (rng.random(C) * s).astype(np.float32)
    w_ab, c_ab = mk(5), np.floor(mk(20))
    w_a, w_b = mk(50), mk(50)
    c_a = np.maximum(c_ab, np.floor(mk(100)))
    c_b = np.maximum(c_ab, np.floor(mk(100)))
    lanes = [_t(x, cuda) for x in (w_ab, c_ab, w_a, w_b, c_a, c_b)]
    ok = _t(rng.random(C) < 0.8, cuda)
    lt = _t(rng.integers(0, 20, C).astype(np.int32), cuda)
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda)
          for x in (1e4, 2e4, 25.0)]
    got = score_gate(*lanes, ok, lt, *sc, coefs=COEFS, half_life=half_life,
                     **GATES)
    w_eff = lanes[0]
    if half_life is not None:
        w_eff = decay_exp2(w_eff, lt, sc[2], half_life)
    exp = ref.score_gate_ref(w_eff, *lanes[1:], ok, sc[0], sc[1], COEFS,
                             **GATES)
    _assert_gated_equal(got, exp, w_eff)


@pytest.mark.parametrize("half_life", [None, 6.0])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("live", [0.014, 0.8])
@pytest.mark.parametrize("C", [0, 1, 4095, 4099, 3 * 4096 + 17])
def test_score_gate_cuda_tiles_and_routes(cuda, C, live, offset, half_life):
    """Ragged and empty capacities, a store-like 1.4% base gate, and bases
    one element off 16-byte alignment (the 4-byte route): the wrapper and
    its bare launch into a buffer of 7.0s (every slot written) bit-equal to
    the plain version."""
    lanes_np, ok_np, lt_np = _score_lanes(C, C + 7, live)
    lanes = [_on_card(x, cuda, offset) for x in lanes_np]
    ok = _on_card(ok_np, cuda, offset)
    lt = _on_card(lt_np, cuda, offset)
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda)
          for x in (1e4, 2e4, 25.0)]
    before = tk.LAUNCHES["score_gate"]
    routes = dict(ktk.SCORE_ROUTE_LAUNCHES)
    got = score_gate(*lanes, ok, lt, *sc, coefs=COEFS, half_life=half_life,
                     **GATES)
    assert got.shape == (C,)
    assert tk.LAUNCHES["score_gate"] == before + (C > 0)
    kroute = "scalar" if offset else "vec"
    assert ktk.SCORE_ROUTE_LAUNCHES[kroute] == routes[kroute] + (C > 0)
    w_eff = lanes[0]
    if half_life is not None:
        w_eff = decay_exp2(w_eff, lt, sc[2], half_life)
    exp = ref.score_gate_ref(w_eff, *lanes[1:], ok, sc[0], sc[1], COEFS,
                             **GATES)
    _assert_gated_equal(got, exp, w_eff)
    lt_ptr = None if half_life is None else lt.data_ptr()
    out = torch.full_like(got, 7.0)
    ktk.launch_score_gate(lanes, ok, lt_ptr, torch.stack(sc), COEFS,
                          tuple(GATES.values()), half_life, out)
    assert torch.equal(out.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("shape,k,kind", [
    ((4096, 64), 8, "ties"), ((7, 40), 8, "ties"), ((33, 64), 16, "ties"),
    ((5, 3), 6, "ties"), ((100, 128), 8, "ties"), ((9, 100), 16, "ties"),
    ((300, 64), 32, "ties"), ((300, 64), 33, "ties"),
    ((1000, 128), 32, "ties"), ((70, 100), 33, "ties"),
    ((20000, 64), 8, "sparse"), ((4099, 64), 8, "offset"),
    ((257, 40), 6, "offset")])
def test_bucket_topk_cuda_matches_plain(cuda, shape, k, kind):
    """Both kernel routes (row for k <= 32, warp above) against the plain
    version: values and every column, sentinels included; "sparse" rows
    are >= 99% -inf as the hash path's grid, "offset" grids start 4 bytes
    past a 16-byte boundary (a slice of a larger tensor)."""
    from repro_torch.kernels import topk_select as ktk
    rng = np.random.default_rng(shape[0])
    g = np.floor(rng.random(shape).astype(np.float32) * 20)   # many ties
    g[rng.random(shape) < 0.3] = -np.inf
    g[0, :] = -np.inf
    if kind == "sparse":
        g[rng.random(shape[0]) >= 0.01] = -np.inf
    if kind == "offset":
        flat = torch.empty(g.size + 1, dtype=torch.float32, device=cuda)
        grid = flat[1:].view(shape)
        grid.copy_(torch.from_numpy(g))
        assert grid.is_contiguous() and grid.data_ptr() % 16 == 4
    else:
        grid = torch.tensor(g, device=cuda)
    kroute = ktk.kernel_route(k)
    assert kroute == ("row" if k <= 32 else "warp")
    before, by_route = tk.LAUNCHES["bucket_topk"], dict(ktk.ROUTE_LAUNCHES)
    vals, args = bucket_topk(grid, k)
    assert tk.LAUNCHES["bucket_topk"] == before + 1
    assert ktk.ROUTE_LAUNCHES[kroute] == by_route[kroute] + 1
    ev, ea = ref.bucket_topk_ref(grid, k)
    assert torch.equal(vals, ev)
    assert torch.equal(args, ea)
    fin = ev > -torch.inf
    assert bool((args[~fin] == shape[1]).all())
    if kroute == "row":   # the warp route, forced, on the same grid
        wv, wa = torch.empty_like(vals), torch.empty_like(args)
        ktk.launch_bucket_topk(grid, wv, wa, "warp")
        assert torch.equal(wv, ev) and torch.equal(wa, ea)
    with pytest.raises(ValueError):
        bucket_topk(torch.zeros((2, 129), device=cuda), 2)


@pytest.mark.parametrize("W,MC", [(8, 4), (16, 8), (128, 8), (100, 3),
                                  (128, 12)])
def test_chain_find_cuda_matches_plain(cuda, W, MC):
    """Dense (90% active, one warp a row), sparse (4% active over
    32 x target_warps + 1 rows, 1,622,017 on an H100, whole 32-row groups
    idle, 32 rows a warp, the most the kernel takes) and misaligned: the
    active flags 1 byte and the dst keys 4 bytes off a 16-byte boundary,
    and the key lanes 4 bytes off (the 4-byte route where W % 4 == 0 would
    take the 16-byte one)."""
    rng = np.random.default_rng(W + MC)
    R, B = 512, 5000
    kh = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    kl = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    kh[rng.random((R, W)) < 0.3] = 0
    kl[kh == 0] = 0
    kh[:, -1], kl[:, -1] = kh[:, 0], kl[:, 0]    # a key twice in a region
    kh[:, 3], kl[:, 3] = kh[:, 2], kl[:, 2]      # twice in one lane's four
    depth = rng.integers(0, MC + 1, B)              # -1-terminated prefixes
    regs = rng.integers(0, R, (B, MC)).astype(np.int32)
    regs[np.arange(MC)[None, :] >= depth[:, None]] = -1
    r0 = np.maximum(regs[np.arange(B), rng.integers(0, MC, B)], 0)
    c0 = rng.integers(0, W, B)
    dh, dl = kh[r0, c0], kl[r0, c0]                 # mostly present keys
    absent = rng.random(B) < 0.3
    dh[absent] ^= np.uint32(0xBEEF)
    active = rng.random(B) < 0.9
    args = [_t(x, cuda) for x in (kh, kl, regs, dh, dl, active)]
    before = tk.LAUNCHES["chain_find"]
    got = chain_find(*args)
    assert tk.LAUNCHES["chain_find"] == before + 1
    exp = ref.chain_find_ref(*args)
    assert torch.equal(got, exp)
    assert int((got >= 0).sum()) > B // 3 and int((got < 0).sum()) > B // 10

    target = kprobe.target_warps(cuda, W, kprobe.kernel_route(
        *args[:2]) == "vec")
    big = 32 * target + 1                 # 32 rows a warp, the kernel's
    idx = np.arange(big) % B              # most
    sparse = active[idx] & (rng.random(big) < 0.04)
    sparse[64:40000] = False
    s_args = args[:2] + [_t(x[idx], cuda) for x in (regs, dh, dl)] \
        + [_t(sparse, cuda)]
    assert kprobe.rows_per_warp(big, target) == 32
    assert kprobe.rows_per_warp(B, target) == 1
    got = chain_find(*s_args)
    assert torch.equal(got, ref.chain_find_ref(*s_args))
    assert 0 < int(sparse.sum()) <= 0.05 * big and int((got >= 0).sum()) > 0

    def off(x, n):   # a copy of x whose base is n elements past an aligned one
        buf = torch.empty(x.numel() + n, dtype=x.dtype, device=cuda)
        y = buf[n:].view(x.shape)
        y.copy_(x)
        return y

    m_args = [off(args[0], 1), off(args[1], 1), args[2], off(args[3], 1),
              off(args[4], 1), off(args[5], 1)]
    assert m_args[5].data_ptr() % 16 == 1 and m_args[3].data_ptr() % 16 == 4
    assert kprobe.kernel_route(*m_args[:2]) == "scalar"
    assert kprobe.kernel_route(*args[:2]) == ("vec" if W % 4 == 0
                                              else "scalar")
    by_route = dict(kprobe.ROUTE_LAUNCHES)
    got = chain_find(*m_args)
    assert kprobe.ROUTE_LAUNCHES["scalar"] == by_route["scalar"] + 1
    assert torch.equal(got, exp)
    with pytest.raises(ValueError):
        chain_find(torch.zeros((4, 256), dtype=torch.int32, device=cuda),
                   torch.zeros((4, 256), dtype=torch.int32, device=cuda),
                   *args[2:])


def _region_rank_on_card(lanes, ok_t, lt_t, sc, K, W, half_life, kroute):
    """region_rank on the card against the plain version: exact, apart from
    rows where the lazy gate sits within 1 ulp of min_pair_weight. The
    wrapper (on its route) and, where it is given, the other route forced
    through the bare launch. Returns npass."""
    before = tk.LAUNCHES["region_rank"]
    by_route = dict(ktk.REGION_ROUTE_LAUNCHES)
    vals, args, npass = region_rank(*lanes, ok_t, lt_t, *sc, k=K,
                                    coefs=COEFS, half_life=half_life, **GATES)
    assert tk.LAUNCHES["region_rank"] == before + 1
    route = ktk.kernel_route(K)
    assert ktk.REGION_ROUTE_LAUNCHES[route] == by_route[route] + 1
    outs = [(vals, args, npass)]
    if kroute is not None:
        bufs = (torch.empty_like(vals), torch.empty_like(args),
                torch.empty_like(npass))
        ktk.launch_region_rank(
            lanes, ok_t, None if half_life is None else lt_t.data_ptr(),
            torch.stack(sc), COEFS, tuple(GATES.values()), half_life, *bufs,
            kroute=kroute)
        outs.append(bufs)
    w_eff = lanes[0]
    if half_life is not None:
        w_eff = decay_exp2(w_eff, lt_t, sc[2], half_life)
    ev, ea, en = ref.region_rank_ref(w_eff, *lanes[1:], ok_t, sc[0], sc[1],
                                     K, COEFS, **GATES)
    # a row may differ only where the lazy gate sits within 1 ulp of
    # min_pair_weight; every other row is exact.
    near = ((w_eff - GATES["min_pair_weight"]).abs()
            <= 2.0 ** -23 * 0.25).any(1)
    R = w_eff.shape[0]
    for v, a, n in outs:
        same = (n == en) & (v == ev).all(1) & (a == ea).all(1)
        assert bool((same | near).all())
        assert int(same.sum()) > 0.99 * R
        assert bool((a[v == -torch.inf] == W).all())
    return npass


@pytest.mark.parametrize("half_life", [None, 6.0])
@pytest.mark.parametrize("R,W,K", [(4096, 128, 8), (300, 16, 8), (50, 40, 16),
                                   (600, 64, 40)])
def test_region_rank_cuda_matches_plain(cuda, half_life, R, W, K):
    """Dense (80% of slots live) on the wrapper's route, the other route
    forced on the same grid; then sparse as the region store fills it
    (live slots a prefix of each row, at least 80% of rows all gated).
    K 40 takes the warp route."""
    rng = np.random.default_rng(R + W)
    mk = lambda *s: (rng.random(s) * 1.0).astype(np.float32)
    w_ab, c_ab = np.floor(mk(R, W) * 20) / 4, np.floor(mk(R, W) * 20)
    w_a, w_b = np.floor(mk(R) * 50), np.floor(mk(R, W) * 50)   # many ties
    c_a = np.floor(mk(R) * 100) + 20
    c_b = np.maximum(c_ab, np.floor(mk(R, W) * 100))
    ok = rng.random((R, W)) < 0.8
    ok[0] = False
    lt = rng.integers(0, 20, (R, W)).astype(np.int32)
    lanes = [_t(x, cuda) for x in (w_ab, c_ab, w_a, w_b, c_a, c_b)]
    ok_t, lt_t = _t(ok, cuda), _t(lt, cuda)
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda)
          for x in (1e4, 2e4, 25.0)]
    other = "warp" if ktk.kernel_route(K) == "row" else None
    _region_rank_on_card(lanes, ok_t, lt_t, sc, K, W, half_life, other)

    fill = rng.integers(1, W + 1, R)
    fill[rng.permutation(R)[: int(0.85 * R)]] = 0   # 85% of regions free
    sparse = np.arange(W)[None, :] < fill[:, None]
    npass = _region_rank_on_card(lanes, _t(sparse, cuda), lt_t, sc, K, W,
                                 half_life, other)
    assert float((npass == 0).float().mean()) >= 0.8 and int(npass.sum()) > 0
    with pytest.raises(ValueError):
        region_rank(*(torch.zeros((2, 129), device=cuda) for _ in range(2)),
                    torch.zeros(2, device=cuda),
                    torch.zeros((2, 129), device=cuda),
                    torch.zeros(2, device=cuda),
                    torch.zeros((2, 129), device=cuda),
                    torch.zeros((2, 129), dtype=torch.bool, device=cuda),
                    None, *sc, k=K, coefs=COEFS, **GATES)


def test_assoc_score_cuda_matches_plain(cuda):
    rng = np.random.default_rng(12)
    C = 1 << 16
    mk = lambda s: (rng.random(C) * s).astype(np.float32)
    w_ab, c_ab = mk(5), np.floor(mk(20))
    c_a = np.maximum(c_ab, np.floor(mk(100)))
    c_b = np.maximum(c_ab, np.floor(mk(100)))
    lanes = [_t(x, cuda) for x in (w_ab, c_ab, mk(50), mk(50), c_a, c_b)]
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda)
          for x in (1e4, 2e4)]
    before = tk.LAUNCHES["assoc_score"]
    got = assoc_score(*lanes, *sc, coefs=COEFS)
    assert tk.LAUNCHES["assoc_score"] == before + 1
    exp = score_body(*lanes, *sc, COEFS)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("live", [0.014, 0.8])
@pytest.mark.parametrize("C", [0, 1, 4095, 4099, 3 * 4096 + 17])
def test_assoc_score_cuda_tiles_and_routes(cuda, C, live, offset):
    """As the score_gate case: the wrapper and its bare launch bit-equal to
    score_body on either route, with 0, -0.0, -1 and NaN in c_ab and inf/NaN
    in the other lanes of those slots, which the gate skips."""
    from repro_torch.kernels import assoc_score as kas
    lanes_np, _, _ = _score_lanes(C, C + 11, live)
    rng = np.random.default_rng(C)
    odd = rng.random(C) < 0.05
    lanes_np[1][odd] = rng.choice(np.array([0.0, -0.0, -1.0, np.nan],
                                           np.float32), int(odd.sum()))
    for x in (lanes_np[0], *lanes_np[2:]):
        x[odd] = rng.choice(np.array([np.inf, -np.inf, np.nan, 1.0],
                                     np.float32), int(odd.sum()))
    lanes = [_on_card(x, cuda, offset) for x in lanes_np]
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda)
          for x in (1e4, 2e4)]
    before = tk.LAUNCHES["assoc_score"]
    routes = dict(kas.ROUTE_LAUNCHES)
    got = assoc_score(*lanes, *sc, coefs=COEFS)
    assert got.shape == (C,)
    assert tk.LAUNCHES["assoc_score"] == before + (C > 0)
    kroute = "scalar" if offset else "vec"
    assert kas.ROUTE_LAUNCHES[kroute] == routes[kroute] + (C > 0)
    exp = score_body(*lanes, *sc, COEFS)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    out = torch.full_like(got, 7.0)
    kas.launch_assoc_score(lanes, torch.stack(sc), COEFS, out)
    assert torch.equal(out.view(torch.int32), got.view(torch.int32))


MARGINALS = ("w_a", "w_b", "c_a", "c_b", "total_w", "total_c")


def _odd_marginal(lanes, tot, lane, value, seed, rows=None):
    """Copies of the numpy ``lanes`` and ``tot`` with ``value`` in one
    marginal at about 30% of the slots with c_ab > 0 (of the rows holding
    one, for a per-row lane of a ``rows``-row grid), or the whole total."""
    lanes = [x.copy() for x in lanes]
    tot = list(tot)
    rng = np.random.default_rng(seed)
    if lane.startswith("total"):
        tot[lane == "total_c"] = np.float32(value)
        return lanes, tot
    x = lanes[("w_a", "w_b", "c_a", "c_b").index(lane) + 2]
    live = lanes[1] > 0
    if x.ndim < live.ndim:
        live = live.any(1)
    x[live & (rng.random(x.shape) < 0.3)] = value
    return lanes, tot


def _assert_nan_where_plain_nan(got, exp):
    """NaN exactly where the plain version is NaN (any sign or payload),
    every other value bit for bit."""
    assert torch.equal(torch.isnan(got), torch.isnan(exp))
    fin = ~torch.isnan(exp)
    assert torch.equal(got[fin].view(torch.int32), exp[fin].view(torch.int32))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("lane", MARGINALS)
def test_score_kernels_cuda_nan_inf_marginals(cuda, lane, value, offset):
    """score_gate and assoc_score with NaN or +-inf in one marginal of
    slots with c_ab > 0, on the 16-byte route and (offset 1) the 4-byte
    route: NaN exactly where the plain versions give NaN (the body's
    clamps propagate it, as clamp_min does), bit for bit elsewhere."""
    C = 3 * 4096 + 17
    lanes_np, ok_np, lt_np = _score_lanes(C, C + 5, 0.8)
    lanes_np, tot = _odd_marginal(lanes_np, (1e4, 2e4), lane, value, C)
    lanes = [_on_card(x, cuda, offset) for x in lanes_np]
    ok = _on_card(ok_np, cuda, offset)
    lt = _on_card(lt_np, cuda, offset)
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda)
          for x in (*tot, 25.0)]
    got = score_gate(*lanes, ok, lt, *sc, coefs=COEFS, half_life=None,
                     **GATES)
    exp = ref.score_gate_ref(*lanes, ok, sc[0], sc[1], COEFS, **GATES)
    _assert_nan_where_plain_nan(got, exp)
    got = assoc_score(*lanes, sc[0], sc[1], coefs=COEFS)
    _assert_nan_where_plain_nan(got, score_body(*lanes, sc[0], sc[1],
                                                COEFS))
    if lane in ("c_a", "c_b", "total_w", "total_c") and np.isnan(value):
        assert bool(torch.isnan(exp).any())


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("lane", MARGINALS)
@pytest.mark.parametrize("R,W,K", [(4096, 128, 8), (600, 64, 40)])
def test_region_rank_cuda_nan_inf_marginals(cuda, R, W, K, lane, value):
    """region_rank on both kernel routes (the wrapper's, the other forced)
    with NaN or +-inf in one marginal where c_ab > 0: values NaN exactly
    where region_rank_ref's are (a region whose list holds a NaN gives NaN
    with the sentinel column in every round, as the Pallas kernel does),
    every other value, column and npass equal."""
    rng = np.random.default_rng(R + W + 1)
    mk = lambda *s: rng.random(s).astype(np.float32)
    w_ab, c_ab = np.floor(mk(R, W) * 20) / 4, np.floor(mk(R, W) * 20)
    w_a, w_b = np.floor(mk(R) * 50), np.floor(mk(R, W) * 50)
    c_a = np.floor(mk(R) * 100) + 20
    c_b = np.maximum(c_ab, np.floor(mk(R, W) * 100))
    ok = rng.random((R, W)) < 0.8
    lanes_np, tot = _odd_marginal((w_ab, c_ab, w_a, w_b, c_a, c_b),
                                  (1e4, 2e4), lane, value, R * K, rows=R)
    lanes = [_t(x, cuda) for x in lanes_np]
    ok_t = _t(ok, cuda)
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda)
          for x in (*tot, 25.0)]
    vals, args, npass = region_rank(*lanes, ok_t, None, *sc, k=K,
                                    coefs=COEFS, half_life=None, **GATES)
    outs = [(vals, args, npass)]
    if ktk.kernel_route(K) == "row":       # the warp route, forced
        bufs = (torch.empty_like(vals), torch.empty_like(args),
                torch.empty_like(npass))
        ktk.launch_region_rank(lanes, ok_t, None, torch.stack(sc), COEFS,
                               tuple(GATES.values()), None, *bufs,
                               kroute="warp")
        outs.append(bufs)
    ev, ea, en = ref.region_rank_ref(*lanes, ok_t, sc[0], sc[1], K, COEFS,
                                     **GATES)
    for v, a, n in outs:
        _assert_nan_where_plain_nan(v, ev)
        assert torch.equal(a, ea) and torch.equal(n, en)
    if lane in ("c_a", "c_b", "total_w", "total_c") and np.isnan(value):
        assert bool(torch.isnan(ev).any())


@pytest.mark.parametrize("shape,k", [((4096, 64), 8), ((300, 64), 33),
                                     ((257, 40), 6)])
def test_bucket_topk_cuda_nan_rows(cuda, shape, k):
    """NaN (either sign) in a third of the rows: on both routes such a row
    gives NaN with the sentinel column in every round, as the plain
    version and the Pallas kernel do; every other row bit for bit."""
    rng = np.random.default_rng(shape[0] + k)
    g = np.floor(rng.random(shape).astype(np.float32) * 20)
    g[rng.random(shape) < 0.3] = -np.inf
    g[rng.random(shape) < 0.05] = np.inf
    nan = (rng.random(shape) < 0.1) & (rng.random((shape[0], 1)) < 0.33)
    g[nan] = rng.choice(np.array([np.nan, -np.nan], np.float32),
                        int(nan.sum()))
    g[1] = np.nan
    grid = torch.tensor(g, device=cuda)
    ev, ea = ref.bucket_topk_ref(grid, k)
    vals, args = bucket_topk(grid, k)
    outs = [(vals, args)]
    if ktk.kernel_route(k) == "row":
        wv, wa = torch.empty_like(vals), torch.empty_like(args)
        ktk.launch_bucket_topk(grid, wv, wa, "warp")
        outs.append((wv, wa))
    for v, a in outs:
        _assert_nan_where_plain_nan(v, ev)
        assert torch.equal(a, ea)
    nan_row = torch.isnan(grid).any(1)
    assert bool(torch.isnan(vals[nan_row]).all())
    assert bool((args[nan_row] == shape[1]).all())
    assert bool((~torch.isnan(vals[~nan_row])).all())


ED_ROUTE = {1.0: "half", 1.5: "half", 1.3: "f32"}


def _edit_distance_on_card(cuda, args, fc):
    """The wrapper on the card, checked for one launch on fc's route and
    held bit for bit against the plain version."""
    route = ED_ROUTE[fc]
    assert ked.kernel_route(fc) == route
    before, by_route = tk.LAUNCHES["edit_distance"], dict(ked.ROUTE_LAUNCHES)
    got = edit_distance(*args, first_char_cost=fc)
    assert tk.LAUNCHES["edit_distance"] == before + 1
    assert ked.ROUTE_LAUNCHES[route] == by_route[route] + 1
    exp = ref.edit_distance_ref(*args, first_char_cost=fc)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    return got


@pytest.mark.parametrize("fc", [1.0, 1.5, 1.3])
@pytest.mark.parametrize("L", [16, 24, 32])
def test_edit_distance_cuda_matches_plain(cuda, L, fc):
    rng = np.random.default_rng(L)
    rand = lambda n, k: "".join(chr(97 + c) for c in rng.integers(0, k, n))
    pairs = [(rand(rng.integers(0, L + 1), k), rand(rng.integers(0, L + 1), k))
             for k in (2, 3, 6) for _ in range(3000)]
    full = rand(L, 4)
    # an odd count: the half route's last thread has an empty high lane
    pairs += [("", "a"), ("", ""), ("", full), (full, ""), (full, full),
              (full, full[::-1]), ("justin bieber", "justin beiber"),
              ("same", "same"), (rand(L, 2), rand(L, 2))]
    assert len(pairs) % 2 == 1
    A, B = zip(*pairs)
    ac, al = encode_strings(list(A), L)
    bc, bl = encode_strings(list(B), L)
    args = [torch.from_numpy(x).to(cuda) for x in (ac, al, bc, bl)]
    got = _edit_distance_on_card(cuda, args, fc)
    d = got[-8:].tolist()
    assert d[0] == 0.0 and d[3] == 0.0 and d[6] == 0.0
    # row 0 of the table, fc + (L - 1) in f32
    assert d[1] == d[2] == float(np.float32(fc) + np.float32(L - 1))
    assert not torch.signbit(got).any()


@pytest.mark.parametrize("fc", [1.5, 1.3])
def test_edit_distance_cuda_source_major_batch(cuda, fc):
    """Pairs as the spelling job makes them: each source against every
    candidate within 2 of its length, source-major."""
    rng = np.random.default_rng(17)
    words = list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 8, n))
        for n in rng.integers(4, 25, 3000)))
    ch, ln = encode_strings(words, 24)
    src = rng.choice(len(words), 40, replace=False)
    near = np.abs(ln[src, None] - ln[None, :]) <= 2
    aa, bb = np.nonzero(near)
    aa = src[aa]
    args = [torch.from_numpy(x).to(cuda)
            for x in (ch[aa], ln[aa], ch[bb], ln[bb])]
    got = _edit_distance_on_card(cuda, args, fc).cpu().numpy()
    assert (got[aa == bb] == 0).all() and (got[aa != bb] > 0).all()


@pytest.mark.parametrize("fc", [1.5, 1.3])
def test_edit_distance_cuda_unaligned_base(cuda, fc):
    """Strings and lengths at bases off their alignment, as slices of
    larger tensors: computed right."""
    rng = np.random.default_rng(3)
    n, L = 5001, 24
    ac, bc = (rng.integers(97, 101, (n, L), dtype=np.uint8) for _ in "ab")
    al, bl = (rng.integers(0, L + 1, n).astype(np.int32) for _ in "ab")
    def shifted(x, off):
        flat = torch.zeros(x.size + off, dtype=torch.from_numpy(x).dtype,
                           device=cuda)
        flat[off:] = torch.from_numpy(x.reshape(-1)).to(cuda)
        out = flat[off:].view(x.shape)
        assert out.is_contiguous()
        return out
    args = [shifted(ac, 1), shifted(al, 1), shifted(bc, 7), shifted(bl, 3)]
    assert args[0].data_ptr() % 16 == 1
    _edit_distance_on_card(cuda, args, fc)


def test_edit_distance_wrapper_refuses_bad_inputs(cuda):
    lens = torch.zeros(4, dtype=torch.int32, device=cuda)
    wide = torch.zeros((4, 33), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        edit_distance(wide, lens, wide, lens)
    chars = torch.zeros((4, 24), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        edit_distance(chars, lens, chars, lens)
    chars = torch.zeros((4, 24), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        edit_distance(chars, lens.long(), chars, lens.long())


def test_spelling_and_sketch_on_card_match_cpu(cuda, monkeypatch):
    """The spelling job over the live qstore of the small engine plus
    planted misspellings, and a sketch, on the card and on the CPU."""
    exp = export_live(_run("cpu").state.qstore)
    stream = SyntheticStream(StreamConfig(**STREAM), seed=11)
    fps = join_fp(exp["key_hi"], exp["key_lo"])
    texts = [stream.tok.text(int(f)) for f in fps]
    planted = ["justin bieber", "justin beiber", "hadoop", "hadop",
               "lady gaga", "lady gagga"]
    fps = np.concatenate([fps, np.array([fingerprint(t) for t in planted],
                                        np.uint64)])
    texts += planted
    weights = np.concatenate([exp["weight"], np.float32([900, 5, 800, 4,
                                                         700, 2])])
    tk.reset_launches()
    monkeypatch.setattr(spelling, "BLOCK_CELLS", 1 << 14)   # several blocks
    got = spelling_cycle(fps, texts, weights, device=cuda)
    assert tk.LAUNCHES["edit_distance"] > 1, tk.LAUNCHES
    cpu = spelling_cycle(fps, texts, weights, device="cpu")
    assert list(got.items()) == list(cpu.items())
    assert got[fingerprint("hadop")][0] == fingerprint("hadoop")

    rng = np.random.default_rng(5)
    hi = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    lo = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    w = np.floor(rng.random(3000) * 8).astype(np.float32)
    valid = rng.random(3000) < 0.9
    q = []
    for dev in (cuda, "cpu"):
        sk = tsk.make_sketch(4, 1 << 10, device=dev)
        args = [_t(x, dev) for x in (hi, lo)]
        sk = tsk.sketch_decay(tsk.sketch_update(
            sk, *args, _t(w, dev), _t(valid, dev)), 0.5)
        q.append((sk.table.cpu(), tsk.sketch_query(sk, *args).cpu()))
    assert torch.equal(q[0][0], q[1][0]) and torch.equal(q[0][1], q[1][1])


def _run(device, n_ticks=9, lazy=False, layout="hash"):
    kw = dict(decay=DecayConfig(policy="lazy"), prune_every=4) if lazy else {}
    stream = SyntheticStream(StreamConfig(**STREAM), seed=11)
    eng = SearchAssistanceEngine(EngineConfig(**CFG, **kw, cooc_layout=layout),
                                 device=device)
    for t in range(n_ticks):
        eng.step(*stream.gen_tick(t))
    return eng


@pytest.mark.parametrize("layout", ["hash", "region"])
@pytest.mark.parametrize("lazy", [False, True])
def test_engine_on_card_matches_engine_on_cpu(cuda, lazy, layout):
    """Sweep policy: every kernel of the layout's path runs. Lazy policy:
    no decay sweep; score_gate / region_rank decay in-kernel (half_life)."""
    tk.reset_launches()
    g = _run(cuda, lazy=lazy, layout=layout)
    used = [n for n in tk.PATH_KERNELS[layout]
            if not (lazy and n == "decay_prune_multi")]
    assert all(tk.LAUNCHES[name] > 0 for name in used), tk.LAUNCHES
    assert all(tk.LAUNCHES[name] == 0 for name in tk.KERNELS
               if name not in used), tk.LAUNCHES
    c = _run("cpu", lazy=lazy, layout=layout)
    a, b = g.state_arrays(), c.state_arrays()
    for i in range(len(a)):
        x, y = a[f"leaf_{i}"], b[f"leaf_{i}"]
        if x.dtype == np.float32:
            np.testing.assert_allclose(x, y, rtol=2e-3, err_msg=f"leaf_{i}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"leaf_{i}")
    assert set(g.suggestions) == set(c.suggestions)
    for f in g.suggestions:
        np.testing.assert_allclose([s for _, s in g.suggestions[f][:3]],
                                   [s for _, s in c.suggestions[f][:3]],
                                   rtol=5e-3, atol=1e-4)


def _workload():
    """A small flash crowd (4x at tick 3) with spam bursts."""
    from repro_torch.streaming import (FirehoseWorkload, SpamSpec, SpikeSpec,
                                       WorkloadConfig)
    return FirehoseWorkload(WorkloadConfig(
        vocab_per_lang=128, n_users=500, base_queries_per_tick=64,
        base_tweets_per_tick=8, min_bucket=64, min_tweet_bucket=8,
        spikes=(SpikeSpec(t_start=3, mult=4.0),),
        spam=SpamSpec(period=9, burst_ticks=2)), seed=7)


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_overload_flush_on_card_equals_pertick_step_on_card(cuda, layout):
    """Lag pressure fuses up to 8 ticks into one flush, stepped by the rt
    engine, the bg engine and a mirror; on the card all three end bit for
    bit the per-tick service (and the mirror the rt engine), with the
    layout's kernels launched on the flushes."""
    from repro_torch.core.background import AssistanceService
    from repro_torch.streaming import SLOConfig
    cfg = EngineConfig(**CFG, cooc_layout=layout)
    wl = _workload()
    a = AssistanceService(cfg, device=cuda)
    mirror = SearchAssistanceEngine(cfg, name="rt1", device=cuda)
    b = AssistanceService(cfg, device=cuda, mirrors=[mirror], slo=SLOConfig(
        slo_ms=1e9, up_lag=1e9, lag_batch=0.5, batch_max=8))
    for t in range(17):
        ev, tw = wl.gen_tick(t)
        a.step(ev, tw)
        if t == 4:
            tk.reset_launches()
        b.step(ev, tw, lag_hint=4.0 if t >= 4 else 0.0)
    b.drain()
    assert b.overload.counters["n_flushes"] < 17
    assert tk.LAUNCHES["bucket_topk"] > 0, tk.LAUNCHES
    assert all(tk.LAUNCHES[n] > 0 for n in tk.PATH_KERNELS[layout]
               if n in ("decay_prune_multi", "chain_find")), tk.LAUNCHES
    for x, y in ((a.rt, b.rt), (a.bg, b.bg), (b.rt, mirror)):
        p, q = x.state_arrays(), y.state_arrays()
        for k in p:
            assert p[k].tobytes() == q[k].tobytes(), k


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_compaction_fold_on_card_equals_cpu(cuda, layout, tmp_path):
    """One log, copied: a ``LogCompactor`` on the card and one on the CPU
    fold it to the same floors; the card's base equals the CPU's leaf for
    leaf (ints exact, floats within the card-vs-CPU bound of
    ``test_engine_on_card_matches_engine_on_cpu``), and restores onto the
    card bit for bit what it saved."""
    import shutil
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.streaming import (CompactionConfig, FirehoseLogWriter,
                                       LogCompactor, restore_from_base)
    cfg = EngineConfig(**CFG, cooc_layout=layout)
    w = FirehoseLogWriter(str(tmp_path / "card"), ticks_per_segment=3)
    stream = SyntheticStream(StreamConfig(**STREAM), seed=11)
    for t in range(13):
        w.append(t, *stream.gen_tick(t))
    w.close()
    shutil.copytree(tmp_path / "card", tmp_path / "cpu")
    bases = {}
    for name, dev in (("card", cuda), ("cpu", "cpu")):
        comp = LogCompactor(str(tmp_path / name), {"rt": cfg}, device=dev,
                            cfg=CompactionConfig(keep_bases=2, chunk_ticks=4))
        tk.reset_launches()
        assert [comp.compact(upto_tick=u)["floor"] for u in (6, 12)] == \
            [6, 12]
        if name == "card":
            assert tk.LAUNCHES["decay_prune_multi"] > 0, tk.LAUNCHES
        ck = CheckpointManager(str(tmp_path / name / "firehose-compact" /
                                   "rt"))
        bases[name] = ck.load_arrays(12)[0]
    for k, x in bases["card"].items():
        y = bases["cpu"][k]
        if x.dtype == np.float32:
            np.testing.assert_allclose(x, y, rtol=2e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)
    state, tick, _ = restore_from_base(
        str(tmp_path / "card"), "rt",
        SearchAssistanceEngine(cfg, device=cuda).state)
    eng = SearchAssistanceEngine(cfg, device=cuda)
    eng.state = state
    assert tick == 12 and state.tick.device.type == cuda.type
    for k, x in eng.state_arrays().items():
        assert x.tobytes() == bases["card"][k].tobytes(), k


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_two_runs_on_card_are_bit_identical(cuda, layout):
    a = _run(cuda, layout=layout).state_arrays()
    b = _run(cuda, layout=layout).state_arrays()
    for i in range(len(a)):
        assert a[f"leaf_{i}"].tobytes() == b[f"leaf_{i}"].tobytes(), i


# (B, Hq, Hkv, Tq, Tk, D, causal, window): the JAX package's sweep
# (tests/test_kernels.py), then the LM configs' head dims, ragged T, a
# window wider than T and Hq == Hkv.
FA_SHAPES = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 8, 8, 128, 128, 16, True, 16),
    (2, 4, 1, 1, 64, 32, True, 0),
    (1, 2, 2, 37, 61, 8, False, 0),
    (1, 4, 2, 96, 96, 64, True, 32),
    (2, 32, 8, 300, 300, 80, True, 128),
    (1, 8, 2, 257, 257, 128, True, 0),
    (1, 4, 2, 131, 200, 80, True, 0),
    (1, 4, 4, 100, 100, 16, True, 4096),
    (2, 4, 4, 65, 65, 48, False, 16),
    (1, 32, 8, 1024, 1024, 80, True, 256),   # scoring heads: interior,
]                                            # diagonal, window-edge tiles


def assert_bf16_attention_close(got, exp, v):
    """The bf16 kernel's bound against the f32-P twin: P rounded once to
    bf16 (2^-9 relative) moves a weighted mean of v by at most
    2^-9 max|v|; rtol 2^-7 covers the two final bf16 roundings; and the
    relative RMS error stays within 2^-8 (tests/test_torch_flash_numerics.py
    shows the bound on the CPU, and that the f32-P bar fails)."""
    got, exp = got.float(), exp.float()
    atol = 2 ** -9 * float(v.float().abs().max())
    torch.testing.assert_close(got, exp, rtol=2 ** -7, atol=atol)
    rms = float((got - exp).norm() / exp.norm())
    assert rms <= 2 ** -8, f"relative RMS {rms} > 2^-8"


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cuda_matches_plain(cuda, shape, dtype):
    """f32 within JAX's 2e-4 (sums in another order); bf16 within
    :func:`assert_bf16_attention_close` (the tensor-core kernel rounds P to
    bf16). q/k/v are [B, H, T, D] views of [B, T, H, D] tensors, as the
    model hands them over."""
    B, Hq, Hkv, Tq, Tk, D, causal, window = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape[:6]))
    q = torch.randn((B, Tq, Hq, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, Tk, Hkv, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    before = tk.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, exp, rtol=2e-4, atol=2e-4)
    else:
        assert_bf16_attention_close(got, exp, v)
    contiguous = flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal,
                                 window=window)
    assert torch.equal(contiguous, got)


def test_flash_attention_wrapper_refuses_bad_inputs(cuda):
    q = torch.zeros((1, 4, 8, 16), device=cuda)
    kv = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="all bfloat16 or all float32"):
        flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="all bfloat16 or all float32"):
        flash_attention(q.half(), kv.half(), kv.half())
    for d in (12, 136):
        qd = torch.zeros((1, 4, 8, d), device=cuda)
        kd = torch.zeros((1, 2, 8, d), device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(qd, kd, kd)
    with pytest.raises(ValueError, match="no valid key"):
        flash_attention(q, kv[:, :, :4], kv[:, :, :4], causal=True)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        flash_attention(q, kv[:, :1].expand(1, 3, 8, 16).contiguous(),
                        kv[:, :1].expand(1, 3, 8, 16).contiguous())
    # bf16 goes through TMA: a t-stride of 12 x 2 = 24 bytes is refused.
    wide = torch.zeros((1, 4, 8, 12), device=cuda, dtype=torch.bfloat16)
    kvb = kv.bfloat16()
    with pytest.raises(ValueError, match="t-stride of 24 bytes"):
        flash_attention(wide[..., :8], kvb[..., :8], kvb[..., :8])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "granite-3-8b",
                                  "qwen3-8b", "qwen2-moe-a2.7b",
                                  "mixtral-8x22b"])
def test_lm_smoke_on_card_matches_cpu(cuda, arch):
    """The SMOKE model (f32) on the card against the same weights on the
    CPU: the forward (kernel against twin), then prefill of 64 tokens and 4
    greedy decode steps, logits within 1e-4 (f32 sums in another order;
    TF32 off)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).smoke_config
    cpu = tr.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    card = tr.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu").to(cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))
    tol = dict(rtol=1e-4, atol=1e-4)
    tk.reset_launches()
    got = tr.forward(card, toks.to(cuda), cfg)[0]
    assert tk.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), tr.forward(cpu, toks, cfg)[0],
                               **tol)
    caches = {d: tr.init_caches(cfg, 2, 68, device=d) for d in ("cpu", cuda)}
    gl, caches[cuda] = tr.prefill(card, toks.to(cuda), cfg, caches[cuda])
    cl, caches["cpu"] = tr.prefill(cpu, toks, cfg, caches["cpu"])
    for _ in range(4):
        torch.testing.assert_close(gl.cpu(), cl, **tol)
        nxt = cl[:, -1:].argmax(-1).int() if cl.dim() == 3 else \
            cl.argmax(-1, keepdim=True).int()
        gl, caches[cuda] = tr.decode_step(card, nxt.to(cuda), cfg,
                                          caches[cuda])
        cl, caches["cpu"] = tr.decode_step(cpu, nxt, cfg, caches["cpu"])
    torch.testing.assert_close(gl.cpu(), cl, **tol)
    assert tk.LAUNCHES["flash_attention"] == cfg.n_layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradients_through_the_kernel_equal_the_twins(
        cuda, dtype):
    """``ops.flash_attention`` runs the kernel forward and the twin's
    backward (as JAX's ``custom_vjp`` does): its q/k/v gradients equal the
    twin's own autograd gradients bit for bit, since the backward
    recomputes from the same q/k/v with the same upstream gradient."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 8, 96, 64), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, 2, 96, 64), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    w = torch.randn(q.shape, generator=g, device=cuda).to(dtype)
    grads = []
    for fn in (lambda *a: ops.flash_attention(*a, True, 32),
               lambda *a: ref.flash_attention_ref(*a, causal=True,
                                                  window=32)):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = tk.LAUNCHES["flash_attention"]
        out = fn(*leaves)
        grads.append(torch.autograd.grad((out.float() * w.float()).sum(),
                                         leaves))
        grads[-1] += (tk.LAUNCHES["flash_attention"] - before,)
    assert grads[0][3] == 1 and grads[1][3] == 0
    for a, b in zip(grads[0][:3], grads[1][:3]):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-moe-a2.7b"])
def test_lm_smoke_train_steps_on_card_match_cpu(cuda, arch):
    """Three AdamW steps of the SMOKE model (f32, TF32 off) on the card
    against the same weights and batches on the CPU: losses within rtol
    1e-4, every parameter and state leaf within 1e-3 relative RMS (the CPU
    tests' trajectory bar); the kernel runs once a layer a step."""
    from repro_torch.configs import get_arch
    from repro_torch.data.lm_data import LMDataConfig, SyntheticTokenStream
    from repro_torch.models import api, convert, transformer as tr
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).smoke_config
    tcfg = TrainConfig(opt=opt.AdamWConfig(lr=3e-3, warmup_steps=1,
                                           total_steps=3))
    data = SyntheticTokenStream(LMDataConfig(vocab_size=cfg.vocab_size,
                                             seq_len=32, batch_size=4))
    runs = {}
    for dev in ("cpu", cuda):
        model = tr.init_params(cfg, generator=torch.Generator().manual_seed(
            0), device="cpu").to(dev)
        state = init_train_state(model, tcfg)
        step = make_train_step(api.loss_fn(cfg), tcfg)
        tk.reset_launches()
        losses = []
        for s in range(3):
            model, state, m = step(model, state, {"tokens": torch.from_numpy(
                data.batch(s)).to(dev)})
            losses.append(float(m["loss"]))
        runs[str(dev)] = (losses, convert.train_leaves(model, state),
                          tk.LAUNCHES["flash_attention"])
    (cl, cs, cn), (gl, gs, gn) = runs["cpu"], runs[str(cuda)]
    assert cn == 0 and gn == 3 * cfg.n_layers
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    for a, b in zip(gs, cs):
        a, b = a.cpu().double(), b.double()
        assert float((a - b).norm()) <= 1e-3 * max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x22b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_card_matches_cpu(cuda, arch, dtype):
    """The SMOKE MoE layer on the card against the same weights on the CPU,
    at a capacity that drops: the dispatch of the same router logits
    exact, ``out`` within 1e-5 in f32 (TF32 off) and 2e-2 in bf16, ``aux``
    within 1e-6; two calls on the card bit-identical (no float atomics)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    d = get_arch(arch).smoke_config.d_model
    cfg = dataclasses.replace(get_arch(arch).smoke_config.moe,
                              capacity_factor=0.5, groups=2)
    cpu = moe.init_moe(d, cfg, dtype,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    card = moe.init_moe(d, cfg, dtype,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu").to(cuda)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 64, d)).astype(np.float32)).to(dtype)
    logits = x.reshape(2, -1, d).float() @ cpu.router
    r_cpu, r_card = moe.route(logits, cfg), moe.route(logits.to(cuda), cfg)
    assert torch.equal(r_card.slot_tok.cpu(), r_cpu.slot_tok)
    assert torch.equal(r_card.token_slot.cpu(), r_cpu.token_slot)
    assert int(r_card.n_dropped) == int(r_cpu.n_dropped) > 0
    out, aux = moe.moe_ffn(card, x.to(cuda), cfg)
    again, aux2 = moe.moe_ffn(card, x.to(cuda), cfg)
    assert torch.equal(out, again) and torch.equal(aux, aux2)
    exp, exp_aux = moe.moe_ffn(cpu, x, cfg)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.cpu().float(), exp.float(), rtol=tol,
                               atol=tol)
    assert abs(float(aux) - float(exp_aux)) <= 1e-6


def test_moe_lm_two_forwards_on_card_are_bit_identical(cuda):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tr
    cfg = get_arch("qwen2-moe-a2.7b").smoke_config
    model = tr.init_params(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 128)).astype(np.int32)).to(cuda)
    a, _, aux_a = tr.forward(model, toks, cfg)
    b, _, aux_b = tr.forward(model, toks, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ---------------------------------------------------------------------------
# The tuner and the plan on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["hash", "region"])
def test_tuner_on_card_writes_kernel_for_every_op(cuda, layout, tmp_path):
    import json
    from repro_torch.core.plan import LAYOUT_OPS, OP_KERNELS
    from repro_torch.launch import autotune
    cfg = EngineConfig(**CFG, cooc_layout=layout, ingest_quantum=64)
    tk.reset_launches()
    plan = autotune.tune(cfg, device=cuda, cache=str(tmp_path), repeats=1)
    ops = LAYOUT_OPS[layout]
    assert all(getattr(plan, op) == "kernel" for op in ops), plan
    assert all(tk.LAUNCHES[OP_KERNELS[op]] > 0 for op in ops), tk.LAUNCHES
    assert plan.backend == "cuda" and plan.ingest_chunk == 0
    rec = json.loads(autotune.cache_path(cfg, cuda, str(tmp_path))
                     .read_text())
    for op in ops:
        assert rec["timings_us"][f"{op}:kernel"] > 0
        assert rec["timings_us"][f"{op}:jnp"] > 0
    tk.reset_launches()
    assert autotune.tune(cfg, device=cuda, cache=str(tmp_path)) == plan
    assert sum(tk.LAUNCHES.values()) == 0           # a cache hit


@pytest.mark.parametrize("layout", ["hash", "region"])
def test_a_kernel_that_raises_makes_the_tuner_raise(cuda, layout,
                                                    monkeypatch):
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import autotune

    def boom(*a, **k):
        raise RuntimeError("kernel refused")

    for name in ("score_gate", "bucket_topk", "region_rank", "chain_find",
                 "decay_prune_table"):
        monkeypatch.setattr(kops, name, boom)
    with pytest.raises(RuntimeError, match="kernel refused"):
        autotune.measure_plan(EngineConfig(**CFG, cooc_layout=layout),
                              device=cuda, repeats=1)


@pytest.mark.parametrize("logs", ["rounded", "card"])
@pytest.mark.parametrize("layout", ["hash", "region"])
def test_card_engine_holds_the_contract_against_the_reference(cuda, layout,
                                                              logs):
    """The engine on the card against the port's reference engine (its
    LLR in the engine's float32, with correctly rounded logs or the
    card's) under the parity contract."""
    from repro_torch.core.reference import ReferenceEngine, parity_report
    kw = dict(cooc_layout=layout)
    if layout == "region":      # ample regions: no chain-full drops
        kw.update(cooc_capacity=1 << 16, region_width=64)
    cfg = EngineConfig(**{**CFG, **kw})
    eng = SearchAssistanceEngine(cfg, device=cuda)
    card_log = (lambda v: torch.log(torch.from_numpy(v).to(cuda))
                .cpu().numpy()) if logs == "card" else None
    ref = ReferenceEngine(cfg, llr_f32=True, log_f32=card_log)
    stream = SyntheticStream(StreamConfig(**STREAM), seed=11)
    for t in range(17):
        ev, tw = stream.gen_tick(t)
        eng.step(ev, tw)
        ref.step(ev, tw)
    rep = parity_report(eng, ref)
    assert rep["ok"], rep["faults"]
    assert rep["suggestions"]["compared"] > 0


def _assert_serve_close(got, exp, scale_atol=False):
    """Recsys outputs, card against CPU (f32, TF32 off), within 1e-5: a
    top-k's values, and its ids wherever the value stands more than 1e-5
    from each neighbour or ties it exactly."""
    if not isinstance(exp, tuple):
        atol = 1e-5 * (float(exp.abs().max()) if scale_atol else 1.0)
        torch.testing.assert_close(got.cpu(), exp, rtol=1e-5, atol=atol)
        return
    gv, gi = (t.cpu().numpy() for t in got)
    ev, ei = (t.numpy() for t in exp)
    np.testing.assert_allclose(gv, ev, rtol=1e-5, atol=1e-5)
    gap = np.diff(ev, axis=-1)
    ok = (np.abs(gap) > 1e-5 * np.maximum(np.abs(ev[..., 1:]), 1.0)) | (
        (gap == 0) & (np.diff(gv) == 0))
    clear = np.ones_like(ev, bool)
    clear[..., 1:] &= ok
    clear[..., :-1] &= ok
    np.testing.assert_array_equal(gi[clear], ei[clear])


@pytest.mark.parametrize("arch", ["bst", "xdeepfm", "bert4rec",
                                  "two-tower-retrieval"])
def test_recsys_smoke_on_card_matches_cpu(cuda, arch):
    """Each recsys SMOKE model's serve and retrieval steps on the card
    against the same weights and inputs on the CPU (f32, TF32 off)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).smoke_config
    cpu = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    card = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu").to(cuda)
    for cell in (api.ShapeCell("s", "serve", {"batch": 48}),
                 api.ShapeCell("r", "retrieval",
                               {"batch": 1, "n_candidates": 700})):
        batch = api.make_inputs(np.random.default_rng(1), cfg, cell,
                                device="cpu")["batch"]
        fn = api.serve_fn(cfg, cell)
        got = fn(card, {k: v.to(cuda) for k, v in batch.items()})
        _assert_serve_close(got, fn(cpu, batch), arch == "xdeepfm")


def test_gat_smoke_on_card_matches_cpu(cuda):
    """The GAT SMOKE model through ``adapt_config`` on two cells, on the
    card against the CPU (1e-5); the card's segment sums use float
    atomics, so two runs on the card agree to 1e-6, not bit for bit."""
    from repro_torch.configs import gat_cora
    from repro_torch.models import api, gnn
    torch.backends.cuda.matmul.allow_tf32 = False
    for cell in (gat_cora.SPEC.cell("full_graph_sm"),
                 gat_cora.SPEC.cell("molecule")):
        cfg = gat_cora.adapt_config(gat_cora.SMOKE, cell)
        cpu = api.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
        card = api.init_params(cfg,
                               generator=torch.Generator().manual_seed(0),
                               device="cpu").to(cuda)
        batch = api.make_inputs(np.random.default_rng(2), cfg, cell,
                                device="cpu")["batch"]
        on_card = {k: v.to(cuda) for k, v in batch.items()}
        got = gnn.forward(card, on_card, cfg)
        torch.testing.assert_close(got.cpu(), gnn.forward(cpu, batch, cfg),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(gnn.forward(card, on_card, cfg), got,
                                   rtol=1e-6, atol=1e-6)


def test_jax_gather_rules_and_topk_ties_on_card(cuda):
    """Ids out of range neither assert on the card nor read out of bounds:
    ``take`` gives NaN rows, ``clamped`` clamps, the segment ops drop; and
    ``top_k`` breaks ties to the lowest index with NaN first, as on the
    CPU."""
    from repro_torch.models import gnn, layers
    from repro_torch.models.moe import top_k
    t = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    i = torch.tensor([0, 3, 4, -1, -4, -5, 100], dtype=torch.int32)
    got = layers.take(t.to(cuda), i.to(cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(), layers.take(t, i).numpy())
    assert torch.isnan(got[[2, 5, 6]]).all()
    assert layers.clamped(i.to(cuda), 4).cpu().tolist() == [0, 3, 3, 3, 0, 0,
                                                          3]
    data = torch.arange(5, dtype=torch.float32)
    seg = torch.tensor([0, 5, -1, 1, 1])
    assert gnn.segment_sum(data.to(cuda), seg.to(cuda), 3).cpu().tolist() \
        == [0.0, 7.0, 0.0]
    assert gnn.segment_max(data.to(cuda), seg.to(cuda), 3).cpu().tolist() \
        == [0.0, 4.0, float("-inf")]
    x = torch.tensor([[1.0, 3, 3, 2, 3, float("nan"), float("inf")]])
    torch.cuda.synchronize()
    assert top_k(x, 5)[1][0].tolist() == [5, 6, 1, 2, 4]
    for xs in (x, x.repeat(3, 40)):
        assert torch.equal(top_k(xs.to(cuda), 5)[1].cpu(), top_k(xs, 5)[1])


@pytest.mark.parametrize("C", [1000, 1 << 16])
def test_decay_prune_single_lane_cuda_matches_plain(cuda, C):
    """The single-lane entry launches ``decay_prune.cu`` with no aux
    lanes: keys, lane and live count bit for bit with the plain version;
    the total is a plain sum on both sides, in a different order."""
    from repro_torch.kernels.decay_prune import decay_prune
    rng = np.random.default_rng(C + 1)
    kh = rng.integers(0, 2**32, C, dtype=np.uint32)
    kl = rng.integers(0, 2**32, C, dtype=np.uint32)
    kh[rng.random(C) < 0.4] = 0
    kl[kh == 0] = 0
    w = (rng.random(C) * 3).astype(np.float32)
    before = tk.LAUNCHES["decay_prune_multi"]
    got = decay_prune(_t(kh, cuda), _t(kl, cuda), _t(w, cuda), 0.8, 0.3)
    assert tk.LAUNCHES["decay_prune_multi"] == before + 1
    exp = ref.decay_prune_ref(_t(kh, "cpu"), _t(kl, "cpu"), _t(w, "cpu"),
                              torch.tensor(0.8), 0.3)
    for g, e in zip(got[:3], exp[:3]):
        assert torch.equal(g.cpu().view(torch.int32), e.view(torch.int32))
    assert int(got[3]) == int(exp[4])
    torch.testing.assert_close(got[4].cpu(), exp[5], rtol=1e-5, atol=0)


def test_ops_assoc_score_cuda_matches_plain(cuda):
    from repro_torch.kernels import ops
    rng = np.random.default_rng(13)
    C = (1 << 16) + 5
    mk = lambda s: (rng.random(C) * s).astype(np.float32)
    w_ab, c_ab = mk(5), np.floor(mk(20))
    c_a = np.maximum(c_ab, np.floor(mk(100)))
    c_b = np.maximum(c_ab, np.floor(mk(100)))
    lanes = [_t(x, cuda) for x in (w_ab, c_ab, mk(50), mk(50), c_a, c_b)]
    before = tk.LAUNCHES["assoc_score"]
    got = ops.assoc_score(*lanes, 1e4, 2e4, coefs=COEFS)
    assert tk.LAUNCHES["assoc_score"] == before + 1
    sc = [torch.tensor(x, dtype=torch.float32, device=cuda)
          for x in (1e4, 2e4)]
    exp = ref.assoc_score_ref(*lanes, *sc, COEFS)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.parametrize("W", [16, 100, 128])
def test_chain_find_depth_cuda_matches_plain(cuda, W):
    from repro_torch.kernels.region_probe import chain_find_depth
    rng = np.random.default_rng(W)
    R, B = 512, 5000
    kh = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    kl = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    kh[rng.random((R, W)) < 0.3] = 0
    kl[kh == 0] = 0
    kh[:, -1], kl[:, -1] = kh[:, 0], kl[:, 0]    # a key twice in a region
    reg = rng.integers(0, R, B).astype(np.int32)
    c0 = rng.integers(0, W, B)
    dh, dl = kh[reg, c0], kl[reg, c0]
    dh[rng.random(B) < 0.3] ^= np.uint32(0xBEEF)
    args = (kh, kl, reg, dh, dl)
    before = tk.LAUNCHES["chain_find"]
    got = chain_find_depth(*[_t(x, cuda) for x in args])
    assert tk.LAUNCHES["chain_find"] == before + 1
    exp = chain_find_depth(*[_t(x, "cpu") for x in args])
    assert torch.equal(got.cpu(), exp)
    assert bool((exp == W).any()) and bool((exp < W).any())


def test_insert_accumulate_twopass_on_card_matches_cpu(cuda):
    """The two-pass insert on the card against the CPU, slot for slot,
    over a near-full table that drops; and against the fused insert as a
    key-to-value map where nothing drops."""
    from repro_torch.core import stores as ts
    from repro_torch.core.hashing import from_np_u32
    modes = (("weight", "add"), ("count", "add"), ("peak", "max"),
             ("last_tick", "set"))
    lanes = {"weight": torch.float32, "count": torch.float32,
             "peak": torch.float32, "last_tick": torch.int32}
    rng = np.random.default_rng(21)
    for cap, n_keys in ((1 << 8, 400), (1 << 14, 3000)):
        tabs = {d: ts.make_table(cap, lanes, device=d) for d in (cuda, "cpu")}
        fused = ts.make_table(cap, lanes, device=cuda)
        for tick in range(3):
            keys = rng.integers(1, n_keys, 4096).astype(np.uint64) \
                * np.uint64(0x9E3779B97F4A7C15) | np.uint64(1)
            hi = (keys >> np.uint64(32)).astype(np.uint32)
            lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            upd = {"weight": rng.random(4096).astype(np.float32),
                   "count": np.ones(4096, np.float32),
                   "peak": rng.standard_normal(4096).astype(np.float32),
                   "last_tick": np.full(4096, tick, np.int32)}
            valid = rng.random(4096) < 0.9
            for d in tabs:
                args = (from_np_u32(hi, d), from_np_u32(lo, d),
                        {k: torch.tensor(v, device=d) for k, v in upd.items()},
                        torch.tensor(valid, device=d))
                tabs[d] = ts.insert_accumulate_twopass(tabs[d], *args,
                                                       modes=modes)
                if d == cuda:
                    fused = ts.insert_accumulate(fused, *args, modes=modes)
        a, b = tabs[cuda], tabs["cpu"]
        for x, y in zip((a.key_hi, a.key_lo, *a.lanes.values(), a.n_dropped),
                        (b.key_hi, b.key_lo, *b.lanes.values(), b.n_dropped)):
            assert torch.equal(x.cpu().view(torch.int32), y.view(torch.int32))
        if int(b.n_dropped) == 0:
            assert int(fused.n_dropped) == 0
            ea, ef = export_live(a), export_live(fused)
            ka = join_fp(ea["key_hi"], ea["key_lo"])
            kf = join_fp(ef["key_hi"], ef["key_lo"])
            oa, of = np.argsort(ka), np.argsort(kf)
            np.testing.assert_array_equal(ka[oa], kf[of])
            for name in lanes:
                np.testing.assert_allclose(ea[name][oa], ef[name][of],
                                           rtol=1e-6)
        else:
            assert cap == 1 << 8

"""The row route of ``csrc/region_rank.cu``, written out in numpy.

The CUDA kernel cannot run on the CPU, so this file replays its row route
step by step: a block owns a tile of 32 region rows; warp w takes rows
4w..4w+3 and lane l slots l, l + 32, ..., reading the row's source weight
and its slots' base gate; where the base gate is set and the source
passes ``min_src_weight``, the lane reads the pair weight and
count (decayed in-pass under the lazy policy), applies the threshold
gates, and a ballot and the popcount of the lanes below place each passing
slot in its row's list, in column order; one warp turns the 32 list
lengths into offsets; every thread of the block takes items of the dense
list, finding each one's row by a binary search of the offsets, and
replaces its entry by the slot's score; thread t then offers row t's list,
in order, to the row route's insertion list (``row_topk.cuh``: started at
(``-inf``, W), a value taken only when strictly greater than the last
entry, shifted in behind its equals). It shows the result equal bit for
bit to the plain version ``ref.region_rank_ref``: values, columns with
their sentinels, and npass. The decay and the score are the plain
version's, slot by slot (the kernel's own, under ``-fmad=false``, are held
to them on the card, ``test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import topk_select as tk
from repro_torch.kernels.assoc_score import score_body

ROW_THREADS = 256        # csrc/region_rank.cu kRowThreads
TILE_ROWS = 32           # kTileRows
ROWS_PER_WARP = TILE_ROWS // (ROW_THREADS // 32)
MAX_WIDTH = 128          # kMaxWidth
COEFS = (1.0, 0.15, 0.02, 0.0)
GATES = dict(min_pair_weight=0.25, min_src_weight=0.5, min_pair_count=1.0)


def insert(v, c, x, col):
    """row_topk.cuh's insert on one list (v, c), in place."""
    if not x > v[-1]:
        return
    for i in range(len(v) - 1, 0, -1):
        up, here = x > v[i - 1], x > v[i]
        v[i], c[i] = (v[i - 1], c[i - 1]) if up else \
            ((x, col) if here else (v[i], c[i]))
    if x > v[0]:
        v[0], c[0] = x, col


def row_route(w, c_ab, w_a, ok, score, k, gates=GATES):
    """The row kernel's (vals, args, npass) for the effective pair weight
    ``w`` f32[R, W] (decayed as the plain version decays it), counts
    ``c_ab``, source weights ``w_a`` f32[R], base gate ``ok`` and the
    per-slot ``score`` f32[R, W] (read only where a slot passes)."""
    R, W = w.shape
    nper = 1 if W <= 32 else 2 if W <= 64 else 4
    kmax = tk.row_kmax(k)
    f32 = np.float32
    vals = np.full((R, k), np.nan, f32)
    args = np.full((R, k), -7, np.int32)
    npass = np.full(R, -7, np.int32)
    mpw, msw, mpc = (f32(gates[g]) for g in
                     ("min_pair_weight", "min_src_weight", "min_pair_count"))
    for r0 in range(0, R, TILE_ROWS):
        n = min(TILE_ROWS, R - r0)
        lists = [[] for _ in range(TILE_ROWS)]   # (w, c_ab, col) per row
        cnt = [0] * TILE_ROWS
        for warp in range(ROW_THREADS // 32):
            for i in range(ROWS_PER_WARP):
                r = warp * ROWS_PER_WARP + i
                if r >= n:
                    break
                g = r0 + r
                wa = w_a[g]
                count = 0
                for j in range(nper):
                    cols = np.arange(32) + 32 * j
                    inw = cols < W
                    cc = np.minimum(cols, W - 1)
                    need = (wa >= msw) & inw & ok[g, cc]
                    pw = np.where(need, w[g, cc], f32(0))
                    pc = np.where(need, c_ab[g, cc], f32(0))
                    passing = need & (pw >= mpw) & (pc >= mpc) & (wa >= msw)
                    below = np.cumsum(passing) - passing   # popc(b & lt)
                    for lane in np.nonzero(passing)[0]:
                        kk = count + int(below[lane])
                        assert kk == len(lists[r])
                        lists[r].append([pw[lane], pc[lane], int(cols[lane])])
                    count += int(passing.sum())
                cnt[r] = count
        off = np.concatenate([[0], np.cumsum(cnt)])
        for q in range(int(off[-1])):           # every thread, strided
            r = 0
            step = TILE_ROWS // 2
            while step:
                if off[r + step] <= q:
                    r += step
                step //= 2
            kk = q - off[r]
            e = lists[r][kk]
            e[0] = score[r0 + r, e[2]]
            e[1] = e[2]
        for t in range(n):
            v = [f32(-np.inf)] * kmax
            c = [W] * kmax
            for x, col, _ in lists[t]:
                insert(v, c, x, col)
            vals[r0 + t] = np.asarray(v[:k], f32)
            args[r0 + t] = c[:k]
            npass[r0 + t] = cnt[t]
    return vals, args, npass


def make_grid(R, W, seed, sparse):
    """The region store's lanes: many ties and gate edges; ``sparse`` as
    the engine fills it (live slots a prefix of each row, most rows free),
    else 80% of slots live."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.random(s, dtype=np.float32)
    w_ab = np.floor(mk(R, W) * 20) / 4              # on the 0.25 gate often
    c_ab = np.floor(mk(R, W) * 4)                   # 0 fails the count gate
    w_a = np.floor(mk(R) * 8) / 4                   # some under 0.5
    w_b = np.floor(mk(R, W) * 50)
    c_a = np.floor(mk(R) * 100) + 20
    c_b = np.maximum(c_ab, np.floor(mk(R, W) * 100))
    if sparse:
        fill = np.where(rng.random(R) < 0.2, rng.integers(0, W + 1, R), 0)
        ok = np.arange(W)[None, :] < fill[:, None]
    else:
        ok = rng.random((R, W)) < 0.8
    ok[0] = False
    lt = rng.integers(0, 20, (R, W)).astype(np.int32)
    return w_ab, c_ab, w_a, w_b, c_a, c_b, ok, lt


@pytest.mark.parametrize("half_life", [None, 6.0])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("R,W,K", [(70, 128, 8), (45, 40, 16), (33, 16, 24),
                                   (40, 100, 32), (40, 8, 1)])
def test_row_route_equals_plain_bit_for_bit(R, W, K, sparse, half_life):
    w_ab, c_ab, w_a, w_b, c_a, c_b, ok, lt = make_grid(R, W, R * W + K,
                                                       sparse)
    t = torch.from_numpy
    sc = [torch.tensor(x, dtype=torch.float32) for x in (1e4, 2e4, 25.0)]
    w_eff = t(w_ab)
    if half_life is not None:
        w_eff = tk.decay_exp2(w_eff, t(lt), sc[2], half_life)
    ev, ea, en = ref.region_rank_ref(w_eff, t(c_ab), t(w_a), t(w_b), t(c_a),
                                     t(c_b), t(ok), sc[0], sc[1], K, COEFS,
                                     **GATES)
    score = score_body(w_eff, t(c_ab), t(w_a)[:, None].expand(R, W), t(w_b),
                       t(c_a)[:, None].expand(R, W), t(c_b), sc[0], sc[1],
                       COEFS).numpy()
    v, a, n = row_route(w_eff.numpy(), c_ab, w_a, ok, score, K)
    assert np.array_equal(v.view(np.int32), ev.numpy().view(np.int32))
    assert np.array_equal(a, ea.numpy())
    assert np.array_equal(n, en.numpy())
    assert (n == 0).sum() >= 1 and (n > 0).sum() >= 1
    if sparse:
        assert (n == 0).mean() >= 0.6
    if K > W:
        assert (a[:, W:] == W).all() and np.isneginf(v[:, W:]).all()


@pytest.mark.parametrize("K", [1, 8, 16, 32])
@pytest.mark.parametrize("W", [16, 64, 128])
def test_row_topk_ties_zeros_infs(W, K):
    """The top-k stage on adversarial scores: heavy ties, +-inf, +-0.0 and
    all-gated rows, against bucket_topk_ref over the gated grid."""
    R = 50
    rng = np.random.default_rng(W * 100 + K)
    score = (np.floor(rng.random((R, W)) * 5) - 2).astype(np.float32)
    u = rng.random((R, W))
    score[u < 0.1] = -np.inf
    score[(u >= 0.1) & (u < 0.2)] = np.inf
    score[(score == 0) & (rng.random((R, W)) < 0.5)] = -0.0
    score[3] = np.where(np.arange(W) % 2, 0.0, -0.0)
    score[4] = 1.0
    ok = rng.random((R, W)) < 0.7
    ok[5:9] = False                                  # all gated
    w = np.ones((R, W), np.float32)
    c = np.ones((R, W), np.float32)
    w_a = np.ones(R, np.float32)
    v, a, n = row_route(w, c, w_a, ok, score, K)
    grid = torch.where(torch.from_numpy(ok), torch.from_numpy(score),
                       torch.tensor(-np.inf))
    ev, ea = ref.bucket_topk_ref(grid, K)
    assert np.array_equal(v.view(np.int32), ev.numpy().view(np.int32))
    assert np.array_equal(a, ea.numpy())
    assert np.array_equal(n, ok.sum(1))
    assert (n[5:9] == 0).all() and (a[5:9] == W).all()


@pytest.mark.parametrize("k,route", [(0, "row"), (8, "row"), (32, "row"),
                                     (33, "warp")])
def test_route_check(k, route):
    assert tk.kernel_route(k) == route


def test_tile_fits_static_shared_memory_without_bank_conflicts():
    """The row kernel's static shared memory stays under 48 KB; thread t
    reads row t's list at an odd stride, so a warp's 32 reads of one list
    position hit 32 banks."""
    stride = MAX_WIDTH + 1
    smem = (2 * TILE_ROWS * stride * 4            # w / score, c_ab / column
            + TILE_ROWS * MAX_WIDTH                 # columns
            + 2 * TILE_ROWS * 4 + TILE_ROWS * 4 + (TILE_ROWS + 1) * 4)
    assert smem <= 48 * 1024
    for k in range(MAX_WIDTH):
        assert len({(t * stride + k) % 32 for t in range(32)}) == 32
    assert ROWS_PER_WARP * (ROW_THREADS // 32) == TILE_ROWS
    assert TILE_ROWS == 32                          # one warp scans the counts

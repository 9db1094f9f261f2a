"""The row route of ``csrc/bucket_topk.cu``, written out in numpy.

The CUDA kernel cannot run on the CPU, so this file replays its row route
step by step: the grid staged into a tile at the wrapper's padded stride
(the columns from L to L rounded up to 4 filled with ``-inf``), each row
scanned in ascending column order four columns at a time, a ``KMAX``-long
descending (value, column) list started at (``-inf``, ``L``), a value
taken only when it is strictly greater than the list's last entry, and the
compare-and-shift that puts it behind the entries equal to it. It shows
that the first K entries equal the plain version ``ref.bucket_topk_ref``
bit for bit, values and columns (sentinels included), and checks the
route choice, the tile geometry and the staging's index stepping. The
kernel itself is held against the plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import topk_select as tk

BANK_GROUPS = 8          # 32 banks of 4 bytes, 16 bytes a thread
RESERVED_SMEM = 1024     # shared memory the runtime reserves per block


def row_route(grid: np.ndarray, k: int):
    """The row kernel's result for ``grid`` f32[R, L] and top-``k``, every
    row at once (each row is one thread's work)."""
    R, L = grid.shape
    kmax = tk.row_kmax(k)
    _, stride = tk.row_tile(L)
    lp = (L + 3) // 4 * 4
    tile = np.full((R, stride), np.nan, np.float32)   # past lp: never read
    tile[:, :L] = grid
    tile[:, L:lp] = -np.inf
    v = np.full((R, kmax), -np.inf, np.float32)
    c = np.full((R, kmax), L, np.int32)
    for q in range(lp // 4):
        for col in range(4 * q, 4 * q + 4):
            x = tile[:, col]
            go = x > v[:, -1]
            here = x[:, None] > v
            up = np.zeros_like(here)
            up[:, 1:] = here[:, :-1]                    # x > v[i - 1]
            prev_v = np.concatenate([v[:, :1], v[:, :-1]], 1)
            prev_c = np.concatenate([c[:, :1], c[:, :-1]], 1)
            nv = np.where(up, prev_v, np.where(here, x[:, None], v))
            nc = np.where(up, prev_c, np.where(here, col, c))
            v = np.where(go[:, None], nv, v)
            c = np.where(go[:, None], nc, c)
    return v[:, :k], c[:, :k]


def make_grid(L: int, k: int) -> np.ndarray:
    """Heavy ties, +-inf, +-0.0, and rows that are all -inf, all equal,
    all +inf, increasing (every column inserts) and decreasing."""
    rng = np.random.default_rng(1000 * L + k)
    R = 77
    g = (np.floor(rng.random((R, L)) * 6) - 2).astype(np.float32)
    u = rng.random((R, L))
    g[u < 0.3] = -np.inf
    g[(u >= 0.3) & (u < 0.35)] = np.inf
    g[(g == 0) & (rng.random((R, L)) < 0.5)] = -0.0
    g[0] = -np.inf
    g[1] = 1.0
    g[2] = np.inf
    g[3] = np.arange(L, dtype=np.float32)
    g[4] = -np.arange(L, dtype=np.float32)
    g[5] = -np.inf
    g[5, -1] = 7.0
    g[6] = np.where(np.arange(L) % 2, 0.0, -0.0).astype(np.float32)
    g[7:40][rng.random((33, L)) < 0.97] = -np.inf     # as the hash path
    return g


@pytest.mark.parametrize("k", [1, 6, 8, 16, 32])
@pytest.mark.parametrize("L", [3, 40, 64, 100, 128])
def test_row_route_equals_plain_bit_for_bit(L, k):
    g = make_grid(L, k)
    v, c = row_route(g, k)
    ev, ea = ref.bucket_topk_ref(torch.from_numpy(g), k)
    assert v.shape == (g.shape[0], k)
    assert np.array_equal(v.view(np.int32), ev.numpy().view(np.int32))
    assert np.array_equal(c, ea.numpy())
    if k > L:
        assert (c[:, L:] == L).all() and np.isneginf(v[:, L:]).all()


@pytest.mark.parametrize("k,route", [(0, "row"), (1, "row"), (8, "row"),
                                     (16, "row"), (32, "row"), (33, "warp"),
                                     (64, "warp")])
def test_route_check(k, route):
    assert tk.kernel_route(k) == route
    if route == "row":
        kmax = tk.row_kmax(k)
        assert kmax in tk.ROW_KMAX and kmax >= k
        assert all(m < k for m in tk.ROW_KMAX if m < kmax)


@pytest.mark.parametrize("L", [1, 3, 8, 40, 64, 65, 100, 128])
def test_row_tile_fits_and_reads_without_bank_conflicts(L):
    rows, stride = tk.row_tile(L)
    lp = (L + 3) // 4 * 4
    # the C entry's checks
    assert rows % 32 == 0 and 32 <= rows <= 128
    assert stride % 4 == 0 and stride >= lp
    smem = rows * stride * 4
    assert smem <= tk.SMEM_PER_BLOCK
    # several blocks an SM, so some stage while others select
    assert tk.SMEM_PER_BLOCK // (smem + RESERVED_SMEM) >= 6
    # a quarter-warp's 8 threads, each reading 16 bytes of its own row at
    # the same column, cover 8 distinct groups of 4 banks
    for col in range(0, lp, 4):
        groups = {((t * stride + col) // 4) % BANK_GROUPS for t in range(8)}
        assert len(groups) == BANK_GROUPS


def staged_positions(n_rows: int, L: int, W: int, T: int, stride: int):
    """Where the kernel's stage<W> puts each chunk of an n_rows-row span:
    the (row, col) a thread steps by T chunks without dividing."""
    lw = L // W
    out = {}
    for t in range(T):
        row, col = divmod(t, lw)
        drow, dcol = divmod(T, lw)
        for i in range(t, n_rows * L // W, T):
            out[i] = row * stride + col * W
            row, col = row + drow, col + dcol
            if col >= lw:
                col, row = col - lw, row + 1
    return out


@pytest.mark.parametrize("L", [1, 3, 4, 40, 64, 65, 100, 128])
def test_staging_steps_to_each_element(L):
    T, stride = tk.row_tile(L)
    for W in (1, 4) if L % 4 == 0 else (1,):
        for n_rows in (T, T - 5, 1):     # a full tile and partial last ones
            pos = staged_positions(n_rows, L, W, T, stride)
            e = np.arange(n_rows * L // W) * W
            assert sorted(pos) == list(range(len(e)))
            assert [pos[i] for i in range(len(e))] == list(
                (e // L) * stride + e % L)

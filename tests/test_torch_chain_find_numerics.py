"""``csrc/chain_find.cu`` written out in numpy.

The CUDA kernel cannot run on the CPU, so this file replays it step by
step: a warp owns ``rpw`` consecutive batch rows (a power of two up to 32
that the wrapper's ``rows_per_warp`` sets by the batch size and the
card's ``target_warps``); lane l reads
row0 + l's active flag and a ballot gives the warp its active set (a warp
with none writes -1 for its rows); each active lane holds its dst key and
its first ``HELD_DEPTHS`` region ids; the warp walks its active rows one at
a time in lane order (``__ffs``), reading depths past ``HELD_DEPTHS`` at the
walk, skipping a -1 depth and stopping at the first hit. In a region the 16-byte route gives
lane l slots 4l..4l+3 and takes the lowest lane with a match, then its
first matching slot; the 4-byte route gives lane l slots l, l + 32, ...
and takes the first 32-slot chunk whose ballot is not empty. Each replay
is held bit for bit against the plain version ``ref.chain_find_ref``, and
the route check against the wrapper's. The kernel itself is held against
the plain version on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import region_probe as rp

WARPS_PER_BLOCK = 8     # csrc/chain_find.cu kWarpsPerBlock
MAX_ROWS_PER_WARP = 32  # kMaxRowsPerWarp
HELD_DEPTHS = 8         # kHeldDepths
MAX_WIDTH = 128         # kMaxWidth
# target_warps on an H100: WAVES waves of 48 resident warps an SM (the
# occupancy of the kernel's 38-40 registers) on 132 SMs
H100_TARGET = rp.WAVES * 48 * 132


def ffs(mask: int) -> int:
    """CUDA's __ffs: 1 + the index of the lowest set bit, 0 for none."""
    return (mask & -mask).bit_length()


def ballot(pred) -> int:
    return sum(1 << i for i, p in enumerate(pred) if p)


def find_vec(sh, sl, W, reg, h, l):
    """The 16-byte route's search of one loaded region row (sh, sl: its
    key_hi and key_lo slots), lane by lane."""
    first = []
    for lane in range(32):
        f = 4
        if 4 * lane < W:
            for j in range(3, -1, -1):      # the ternary chain: lowest j wins
                c = 4 * lane + j
                if sh[c] == h and sl[c] == l:
                    f = j
        first.append(f)
    b = ballot(f < 4 for f in first)
    if b == 0:
        return -1
    p = ffs(b) - 1
    return reg * W + 4 * p + first[p]


def find_scalar(sh, sl, W, reg, h, l):
    """The 4-byte route's search: NPER chunks of 32 slots, one ballot each."""
    nper = 1 if W <= 32 else 2 if W <= 64 else 4
    m = [[(c := lane + 32 * j) < W and sh[c] == h and sl[c] == l
          for lane in range(32)] for j in range(nper)]
    pos = -1
    for j in range(nper):
        b = ballot(m[j])
        if pos < 0 and b != 0:
            pos = 32 * j + ffs(b) - 1
    return -1 if pos < 0 else reg * W + pos


def first_row(blk: int, warp: int, rpw: int) -> int:
    """The first of the ``rpw`` consecutive rows a warp owns."""
    return (blk * WARPS_PER_BLOCK + warp) * rpw


def kernel_replay(kh, kl, regs, dh, dl, active, vec: bool, rpw=None):
    """The kernel's result for one launch with ``rpw`` rows a warp (the
    wrapper's ``rows_per_warp`` on an H100 by default), and the count of
    warps that
    had no active row."""
    B, MC = regs.shape
    W = kh.shape[1]
    rpw = rp.rows_per_warp(B, H100_TARGET) if rpw is None else rpw
    find = find_vec if vec else find_scalar
    out = np.full(B, -2, np.int32)         # rows the kernel never wrote
    rows_per_block = WARPS_PER_BLOCK * rpw
    blocks = -(-B // rows_per_block)
    empty = 0
    for blk in range(blocks):
        for warp in range(WARPS_PER_BLOCK):
            row0 = first_row(blk, warp, rpw)
            if row0 >= B:
                continue
            rows = row0 + np.arange(32)
            inr = (np.arange(32) < rpw) & (rows < B)
            act = [bool(i and active[r]) for i, r in zip(inr, rows)]
            todo = ballot(act)
            found = [-1] * 32
            if todo == 0:
                empty += 1
            held = [[regs[r, d] if a and d < MC else -1
                     for d in range(HELD_DEPTHS)]
                    for a, r in zip(act, rows)]
            while todo:                      # one active row at a time
                src = ffs(todo) - 1
                todo &= todo - 1
                h, l = dh[row0 + src], dl[row0 + src]
                hit = -1
                for d in range(HELD_DEPTHS):
                    if hit >= 0 or d >= MC:
                        break
                    r = held[src][d]
                    if r >= 0:
                        hit = find(kh[r], kl[r], W, int(r), h, l)
                d = HELD_DEPTHS
                while hit < 0 and d < MC:
                    r = regs[row0 + src, d]
                    if r >= 0:
                        hit = find(kh[r], kl[r], W, int(r), h, l)
                    d += 1
                found[src] = hit
            out[rows[inr]] = np.asarray(found, np.int32)[inr]
    assert not (out == -2).any()           # every row written once
    return out, empty


def make_batch(W, MC, B, active_share, seed):
    """A region table with empty slots and a key twice in a row, chains
    as -1-terminated prefixes (some ending past HELD_DEPTHS) shared by runs
    of rows, dst keys mostly present, and whole 32-row groups without an
    active row."""
    rng = np.random.default_rng(seed)
    R = 64
    kh = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    kl = rng.integers(0, 2**32, (R, W), dtype=np.uint32)
    kh[rng.random((R, W)) < 0.3] = 0
    kl[kh == 0] = 0
    kh[:, -1], kl[:, -1] = kh[:, 0], kl[:, 0]        # a key twice in a row
    if W > 3:                                     # twice in one lane's four
        kh[:, 3], kl[:, 3] = kh[:, 2], kl[:, 2]
    depth = rng.integers(0, MC + 1, B)
    depth[: B // 4] = MC                              # full chains
    regs = rng.integers(0, R, (B, MC)).astype(np.int32)
    regs[np.arange(MC)[None, :] >= depth[:, None]] = -1
    # runs of rows share a chain (pairs of one source)
    lead = np.maximum.accumulate(np.where(rng.random(B) < 0.35,
                                          np.arange(B), 0))
    regs = regs[lead]
    pick = rng.integers(0, MC, B)
    r0 = np.maximum(regs[np.arange(B), pick], 0)
    c0 = rng.integers(0, W, B)
    dh, dl = kh[r0, c0].copy(), kl[r0, c0].copy()
    dh[rng.random(B) < 0.25] ^= np.uint32(0xBEEF)      # absent keys
    active = rng.random(B) < active_share
    active[32:96] = False                              # two empty groups
    return kh, kl, regs, dh, dl, active


def plain(kh, kl, regs, dh, dl, active):
    t = lambda a: torch.from_numpy(
        a.view(np.int32) if a.dtype == np.uint32 else a)
    return ref.chain_find_ref(t(kh), t(kl), t(regs), t(dh), t(dl),
                              t(active)).numpy()


@pytest.mark.parametrize("active_share", [0.9, 0.04])
@pytest.mark.parametrize("W,MC", [(8, 4), (16, 8), (40, 3), (100, 3),
                                  (128, 8), (128, 12), (30, 11)])
def test_replay_equals_plain_bit_for_bit(W, MC, active_share):
    B = 700
    batch = make_batch(W, MC, B, active_share, seed=W * 100 + MC)
    exp = plain(*batch)
    routes = (True, False) if W % 4 == 0 else (False,)
    for vec in routes:
        for rpw in (1, 4, 32):
            got, empty = kernel_replay(*batch, vec=vec, rpw=rpw)
            assert np.array_equal(got, exp), f"vec={vec} rpw={rpw}"
            assert empty >= 2
    hits = exp >= 0
    assert hits.any() and (~hits & batch[5]).any()


def test_all_inactive_groups_write_minus_one():
    batch = list(make_batch(128, 8, 300, 0.5, seed=3))
    batch[5] = np.zeros(300, bool)
    got, empty = kernel_replay(*batch, vec=True, rpw=32)
    assert (got == -1).all() and empty == -(-300 // 32)
    assert np.array_equal(got, plain(*batch))


def test_depth_skips_and_stops_at_first_hit():
    """A -1 depth is skipped; the key present at depths 1 and 9 is found
    at depth 1; a key only at depth 10 (past the held depths) is found."""
    W, MC = 16, 12
    kh = np.arange(1, 20 * W + 1, dtype=np.uint32).reshape(20, W)
    kl = kh * np.uint32(3)
    kh[9, 2], kl[9, 2] = kh[4, 7], kl[4, 7]
    regs = np.full((3, MC), -1, np.int32)
    regs[0, [1, 9]] = [4, 9]          # depth 0 is -1 (skipped)
    regs[1, :11] = np.arange(11)      # the key lives in region 10 only
    regs[2, :3] = [5, 6, 7]           # absent
    dh = np.array([kh[4, 7], kh[10, 3], 12345], np.uint32)
    dl = np.array([kl[4, 7], kl[10, 3], 1], np.uint32)
    active = np.ones(3, bool)
    exp = plain(kh, kl, regs, dh, dl, active)
    assert list(exp) == [4 * W + 7, 10 * W + 3, -1]
    for vec in (True, False):
        assert np.array_equal(kernel_replay(kh, kl, regs, dh, dl, active,
                                            vec)[0], exp)


@pytest.mark.parametrize("W,offset,route", [(128, 0, "vec"), (16, 0, "vec"),
                                            (128, 1, "scalar"),
                                            (100, 0, "vec"),
                                            (30, 0, "scalar"),
                                            (8, 3, "scalar")])
def test_route_check(W, offset, route):
    R = 6
    flat = torch.zeros(R * W + 8, dtype=torch.int32)
    kh = flat[offset:offset + R * W].view(R, W)
    kl = torch.zeros((R, W), dtype=torch.int32)
    assert kl.data_ptr() % 16 == 0
    assert rp.kernel_route(kh, kl) == route
    assert rp.kernel_route(kh, kh) == route


@pytest.mark.parametrize("B", [1, 20480, H100_TARGET, H100_TARGET + 1,
                               100000, 524288, 10**8])
def test_rows_per_warp(B):
    """A power of two up to 32, the smallest that leaves at most the
    target's warps; on an H100 the region path's small batches (20,480
    rows) get one warp a row, its largest (524,288 rows) 16 rows a warp,
    4,096 blocks."""
    rpw = rp.rows_per_warp(B, H100_TARGET)
    assert rpw in (1, 2, 4, 8, 16, 32)
    assert rpw == MAX_ROWS_PER_WARP or -(-B // rpw) <= H100_TARGET
    assert rpw == 1 or -(-B // (rpw // 2)) > H100_TARGET
    for target in (1, 7 * H100_TARGET):
        small = rp.rows_per_warp(B, target)
        assert small == MAX_ROWS_PER_WARP or -(-B // small) <= target
    if B == 20480:
        assert rpw == 1
    if B == 524288:
        assert rpw == 16 and -(-B // (WARPS_PER_BLOCK * rpw)) == 4096


def test_launch_geometry_and_limits():
    """Every row is one lane of one warp at every rows-per-warp; W up to
    MAX_WIDTH fits one warp's reads at four slots a lane."""
    assert MAX_WIDTH == 4 * 32
    for rpw in (1, 2, 4, 8, 16, 32):
        for B in (1, 31, 32, 33, 255, 256, 257, 1000, 70000):
            seen = np.zeros(B, int)
            blocks = -(-B // (WARPS_PER_BLOCK * rpw))
            for blk in range(blocks):
                for warp in range(WARPS_PER_BLOCK):
                    row0 = first_row(blk, warp, rpw)
                    if row0 >= B:
                        continue
                    r = row0 + np.arange(rpw)
                    seen[r[r < B]] += 1
            assert (seen == 1).all()

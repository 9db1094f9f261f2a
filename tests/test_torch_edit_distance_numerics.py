"""The half-unit route of ``csrc/edit_distance.cu``, written out in numpy.

The CUDA kernel cannot run on the CPU, so this file replays its half-unit
route instruction by instruction on packed 32-bit words: two pairs a
thread as the low and high s16 lanes, characters shifted left by 2, the
DPX add-then-min and min-of-three, the 32-bit adds and multiplies, the
warp-uniform column cut-off (every second column), each pair's result
taken as its row goes by, and ``0.5 *`` at the end. It shows that the
result equals the plain version ``ref.edit_distance_ref`` bit for bit
wherever the wrapper takes the route, and that no lane sum comes near
2^15. The kernel itself
is held against the plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import edit_distance as ked
from repro_torch.kernels import ref

M32 = 0xFFFFFFFF
TWO, ONE = 0x00020002, 0x00010001
COL_STEP = 2        # the kernel's kColStep
WARP = 32


class Lanes:
    """s16x2 arithmetic on uint32 words held in int64 arrays, recording the
    largest lane sum any add forms (before it would wrap)."""

    def __init__(self):
        self.max_sum = 0

    @staticmethod
    def split(v):
        return v & 0xFFFF, (v >> 16) & 0xFFFF

    @staticmethod
    def s16(x):
        return ((x + 0x8000) & 0xFFFF) - 0x8000

    @staticmethod
    def pack(lo, hi):
        return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)

    def _sum(self, a, b):
        out = []
        for x, y in zip(self.split(a), self.split(b)):
            s = self.s16(x) + self.s16(y)
            self.max_sum = max(self.max_sum, int(s.max()))
            out.append(s)
        return out

    def viaddmin(self, a, b, c):        # __viaddmin_s16x2
        s = self._sum(a, b)
        return self.pack(*(np.minimum(self.s16(x), self.s16(z))
                           for x, z in zip(s, self.split(c))))

    def vimin3(self, a, b, c):          # __vimin3_s16x2
        return self.pack(*(np.minimum(np.minimum(self.s16(x), self.s16(y)),
                                      self.s16(z))
                           for x, y, z in zip(self.split(a), self.split(b),
                                              self.split(c))))

    @classmethod
    def vminu2(cls, a, b):              # __vminu2 (unsigned lanes)
        return cls.pack(*(np.minimum(x, y)
                          for x, y in zip(cls.split(a), cls.split(b))))

    def iadd(self, a, b):               # a 32-bit add of packed words
        self._sum(a, b)
        return (a + b) & M32

    def imul(self, a, w):               # a 32-bit multiply by a scalar
        lo, hi = self.split(a)
        self.max_sum = max(self.max_sum, int((lo * w).max()),
                           int((hi * w).max()))
        return (a * w) & M32


def kernel_lmax(L):
    return 16 if L <= 16 else 24 if L <= 24 else 32


def half_unit_kernel(ac, al, bc, bl, fc):
    """The half-unit route of ``ed_half_kernel`` on u8[B, L] strings and
    int lengths. Returns (f32[B], the largest lane sum formed)."""
    w = ked.half_unit_weight(fc)
    assert w is not None
    B, L = ac.shape
    LMAX = kernel_lmax(L)
    T = (B + 1) // 2                    # threads: pairs 2t (lo), 2t+1 (hi)
    pad = 2 * T - B
    ac = np.concatenate([ac, np.zeros((pad, L), np.uint8)]).astype(np.int64)
    bc = np.concatenate([bc, np.zeros((pad, L), np.uint8)]).astype(np.int64)
    al = np.concatenate([np.clip(al, 0, L), np.zeros(pad, int)])
    bl = np.concatenate([np.clip(bl, 0, L), np.zeros(pad, int)])
    al0, al1, bl0, bl1 = al[0::2], al[1::2], bl[0::2], bl[1::2]
    imax = np.maximum(al0, al1)
    # __reduce_max_sync over the warp's threads, then the column cut-off's
    # step: columns j < the first odd j above jmax run
    jmax = np.maximum(bl0, bl1)
    jmax = np.repeat([c.max() for c in np.array_split(
        jmax, np.arange(WARP, T, WARP))], WARP)[:T]
    jcut = np.minimum(jmax + jmax % COL_STEP, LMAX)
    ln = Lanes()
    bp = [np.where(j < jmax, bc[0::2, j] << 2 | bc[1::2, j] << 18, 0)
          if j < L else np.zeros(T, np.int64) for j in range(LMAX)]
    wpk = w * ONE
    row0 = [np.full(T, 0 if j == 0 else wpk + 2 * (j - 1) * ONE, np.int64)
            for j in range(LMAX + 1)]
    zero = [np.zeros(T, np.int64) for _ in range(LMAX + 1)]

    def pick(C, k):
        return np.stack(C)[k, np.arange(T)]

    r0 = np.where(al0 == 0, pick(row0, bl0) & 0xFFFF, 0)
    r1 = np.where(al1 == 0, pick(row0, bl1) >> 16, 0)
    # rows i-3, i-2, i-1: the kernel writes row i over row i-3 (rows 1 and
    # 2 over zeros), so a column past the cut-off keeps row i-3's value
    P3, P2, P1, ap = zero, zero, row0, np.zeros(T, np.int64)
    for i in range(1, int(imax.max(initial=0)) + 1):
        # a thread whose rows have all run takes no more results; the rows
        # it would skip are computed here and never read
        ai = ac[0::2, i - 1] << 2 | ac[1::2, i - 1] << 18
        kind = min(i, 3)
        ap2 = ap | TWO
        C = list(P3)
        C[0] = np.full(T, wpk) if kind == 1 else ln.iadd(P1[0], TWO)
        x_prev = np.zeros(T, np.int64)
        for j in range(1, LMAX + 1):
            x = ai ^ bp[j - 1]
            if kind == 1:
                s = ln.imul(Lanes.vminu2(x, ONE), w)
                d = ln.viaddmin(P1[j], wpk, ln.iadd(P1[j - 1], s))
                d = ln.viaddmin(C[j - 1], wpk if j == 1 else TWO, d)
            elif j == 1:
                s = ln.imul(Lanes.vminu2(x, ONE), w)
                d = ln.viaddmin(P1[1], TWO, ln.iadd(P1[0], s))
                d = ln.viaddmin(C[0], wpk, d)
            else:
                y = ln.iadd(P1[j - 1], x)
                if kind == 2 or j == 2:
                    o = (ap ^ bp[j - 1]) | x_prev
                    t = ln.iadd(np.full(T, wpk), Lanes.vminu2(o, TWO))
                else:
                    t = (ap2 ^ bp[j - 1]) | x_prev
                y = ln.viaddmin(P2[j - 2], t, y)
                d = ln.viaddmin(ln.vimin3(P1[j - 1], P1[j], C[j - 1]), TWO, y)
            C[j] = np.where(j <= jcut, d, C[j])
            x_prev = x
        r0 = np.where(al0 == i, pick(C, bl0) & 0xFFFF, r0)
        r1 = np.where(al1 == i, pick(C, bl1) >> 16, r1)
        P3, P2, P1, ap = P2, P1, C, ai
    r = np.stack([r0, r1], 1).reshape(-1)[:B]
    return np.float32(0.5) * r.astype(np.float32), ln.max_sum


def _strings(rng, n, L, near):
    """n pairs (a, b) as u8[n, L] and lengths: small alphabets (many
    matches and transpositions) and full bytes; |a_len - b_len| <= 2 when
    ``near``; empty and full-length strings included."""
    al = rng.integers(0, L + 1, n)
    bl = (np.clip(al + rng.integers(-2, 3, n), 0, L) if near
          else rng.integers(0, L + 1, n))
    alpha = rng.choice([2, 3, 6, 256], n)
    ac = (rng.integers(0, 1 << 30, (n, L)) % alpha[:, None]).astype(np.uint8)
    bc = (rng.integers(0, 1 << 30, (n, L)) % alpha[:, None]).astype(np.uint8)
    ac[:, :] += np.uint8(97) * (alpha[:, None] < 256)
    bc[:, :] += np.uint8(97) * (alpha[:, None] < 256)
    # a transposition of a into b, and equal strings
    k = n // 8
    bc[:k], bl[:k] = ac[:k], al[:k]
    for r in range(k // 2):
        if al[r] >= 2:
            p = rng.integers(0, al[r] - 1)
            bc[r, [p, p + 1]] = bc[r, [p + 1, p]]
    al[-4:], bl[-4:] = [0, 0, L, L], [0, L, 0, L]
    for x, n_ in ((ac, al), (bc, bl)):
        x[np.arange(L)[None, :] >= n_[:, None]] = 0
    return ac, al.astype(np.int32), bc, bl.astype(np.int32)


def _plain(ac, al, bc, bl, fc):
    return ref.edit_distance_ref(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (ac, al, bc, bl)),
        first_char_cost=fc).numpy()


@pytest.mark.parametrize("near", [True, False])
@pytest.mark.parametrize("L", [16, 24, 32])
@pytest.mark.parametrize("fc", [0.5, 1.0, 1.5, 2.0])
def test_half_unit_route_equals_plain_bit_for_bit(fc, L, near):
    rng = np.random.default_rng([L, int(4 * fc), int(near)])
    # odd: the last thread's high lane holds no pair
    ac, al, bc, bl = _strings(rng, 301, L, near)
    got, max_sum = half_unit_kernel(ac, al, bc, bl, fc)
    exp = _plain(ac, al, bc, bl, fc)
    assert np.array_equal(got.view(np.int32), exp.view(np.int32))
    assert not np.signbit(got).any()
    assert max_sum < 1 << 15


@pytest.mark.parametrize("fc, route", [
    (1.3, "f32"), (1.25, "f32"), (1.5, "half"), (1.0, "half"),
    (0.5, "half"), (0.0, "half"), (-0.0, "f32"), (-0.5, "f32"),
    (512.0, "half"), (512.5, "f32"), (float("nan"), "f32"),
    (float("inf"), "f32")])
def test_route_check(fc, route):
    assert ked.kernel_route(fc) == route
    w = ked.half_unit_weight(fc)
    assert (w is None) == (route == "f32")
    if w is not None:
        assert w == 2 * fc


def test_largest_lane_sum_stays_below_2_15():
    """L 32 at the largest cost the route takes (w = 1024): the largest
    lane sum the kernel forms, from a bound on the table and from strings
    built to reach it (every character 255 against 0, full length)."""
    L, w = 32, ked.MAX_HALF_WEIGHT
    fc = w / 2
    # a cell is at most D[0][j] + the deletions down its column:
    # 2w + 2(i + j - 2); the largest addend is a shifted XOR (1020) or a
    # first-character transposition cost (w + 2)
    bound = 2 * w + 4 * (L - 1) + max(255 << 2, w + 2)
    assert bound < 1 << 15
    rng = np.random.default_rng(32)
    ac, al, bc, bl = _strings(rng, 63, L, near=False)
    ac[:8], bc[:8], al[:8], bl[:8] = 255, 0, L, L
    ac[8:16], bc[8:16], al[8:16], bl[8:16] = 0, 255, L, L
    got, max_sum = half_unit_kernel(ac, al, bc, bl, fc)
    exp = _plain(ac, al, bc, bl, fc)
    assert np.array_equal(got.view(np.int32), exp.view(np.int32))
    assert w < max_sum <= bound


def test_cpu_wrapper_takes_the_plain_version():
    rng = np.random.default_rng(5)
    ac, al, bc, bl = _strings(rng, 17, 24, near=True)
    args = [torch.from_numpy(x) for x in (ac, al, bc, bl)]
    before = dict(ked.ROUTE_LAUNCHES)
    got = ked.edit_distance(*args, first_char_cost=1.5)
    assert ked.ROUTE_LAUNCHES == before
    assert torch.equal(got, ref.edit_distance_ref(*args, first_char_cost=1.5))

"""The tiles of ``csrc/score_gate.cu`` and ``csrc/assoc_score.cu``, written
out in numpy.

The CUDA kernels cannot run on the CPU, so this file replays their index
arithmetic (``csrc/score_tile.cuh``) step by step. A block of 256 threads
owns a tile of 2,048 slots. On the 16-byte route (every base aligned,
the tile full) thread t owns the 4-slot groups t + 256 j; on the 4-byte
route (an unaligned base, or the ragged last tile) it owns slots t + 256 j.
Gate first: a slot passes score_gate's base gate and three threshold gates
(on the weight decayed to ``now`` under the lazy policy), or assoc_score's
``c_ab > 0``. Ballots and the popcount of the lanes below place each passing
slot in its warp's segment of the block's list, in slot order within each
j. After the barrier every thread takes list items q = t, t + 256, ...,
mapping q to its segment from the eight segment lengths, and writes the
slot's score. The owner of every other slot writes the fill: -inf, or for
assoc_score the body evaluated on zeros once per block.

The replay shows every slot written exactly once, each score computed from
its own slot's inputs, and the result bit-equal to the plain versions,
``ref.score_gate_ref`` and ``score_body``, under both decay policies. The
decay and the score are the plain version's, slot by slot (the kernels' own,
under ``-fmad=false``, are held to them on the card, ``test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import topk_select as tk
from repro_torch.kernels.assoc_score import score_body

THREADS = 256            # csrc/score_tile.cuh kThreads
GROUPS = 2               # csrc/score_tile.cuh kGroups: 4-slot groups a thread
WARPS = THREADS // 32
S = THREADS * 4 * GROUPS  # slots a tile holds (kSlots)
P = 4 * GROUPS            # slots a thread owns (kPerThread)
SMEM_PER_SM = 232448     # 227 KB a block may use (sm_90)
COEFS = (1.0, 0.15, 0.02, 0.0)
GATES = dict(min_pair_weight=0.25, min_src_weight=0.5, min_pair_count=1.0)
SC = (1e4, 2e4, 25.0)    # total_w, total_c, now
HALF_LIFE = 6.0
F32 = np.float32


def excl(bits):
    """popc(ballot & lanes below) for each lane."""
    return np.cumsum(bits) - bits


def replay(n, vec, passes, score_of, fill):
    """The kernel's output over ``n`` slots and the writes each slot got.

    ``passes`` is bool[n], the gate each slot's own inputs give;
    ``score_of(slots)`` the scores of the listed slots from their own
    inputs (one call for the whole launch, after every block's list is
    built); ``fill`` the value of every other slot.
    """
    seg_room = 32 * P
    out = np.full(n, np.nan, F32)
    writes = np.zeros(n, np.int64)
    items = []                               # slot of each (block, q)
    for t0 in range(0, n, S):
        m = min(S, n - t0)
        full = vec and m == S
        off_s = np.full(S, -1, np.int64)
        cnt = np.zeros(WARPS, np.int64)
        for warp in range(WARPS):
            t = warp * 32 + np.arange(32)
            seg = warp * seg_room
            count = 0
            mask = np.zeros((32, P), bool)   # the thread's bit mask
            if full:
                for j in range(GROUPS):      # every load before a ballot
                    s0 = 4 * (t + THREADS * j)
                    for k in range(4):
                        mask[:, 4 * j + k] = passes[t0 + s0 + k]
                for j in range(GROUPS):      # place4: a ballot a position
                    s0 = 4 * (t + THREADS * j)
                    bits = mask[:, 4 * j:4 * j + 4]
                    pos = count + sum(excl(bits[:, k]) for k in range(4))
                    count += int(bits.sum())
                    for lane in np.nonzero(bits.any(1))[0]:
                        at = seg + pos[lane]
                        for k in np.nonzero(bits[lane])[0]:
                            assert off_s[at] == -1
                            off_s[at] = s0[lane] + k
                            at += 1
                for j in range(GROUPS):      # fill_vec
                    s0 = 4 * (t + THREADS * j)
                    for k in range(4):
                        fail = ~mask[:, 4 * j + k]
                        i = t0 + s0[fail] + k
                        out[i] = fill
                        writes[i] += 1
            else:
                for j in range(P):
                    s = t + THREADS * j
                    inb = s < m
                    mask[:, j] = inb & passes[t0 + np.minimum(s, m - 1)]
                for j in range(P):           # place: one ballot a slot
                    s = t + THREADS * j
                    bits = mask[:, j]
                    pos = count + excl(bits)
                    count += int(bits.sum())
                    for lane in np.nonzero(bits)[0]:
                        assert off_s[seg + pos[lane]] == -1
                        off_s[seg + pos[lane]] = s[lane]
                for j in range(P):           # fill_scalar
                    s = t + THREADS * j
                    fail = (s < m) & ~mask[:, j]
                    out[t0 + s[fail]] = fill
                    writes[t0 + s[fail]] += 1
            cnt[warp] = count
        off = np.concatenate([[0], np.cumsum(cnt)])
        for q in range(int(off[-1])):        # item_index
            seg_i, base = 0, 0
            for w in range(1, WARPS):
                if q >= off[w]:
                    seg_i, base = w, off[w]
            s = off_s[seg_i * seg_room + q - base]
            assert 0 <= s < m
            items.append(t0 + s)
    items = np.asarray(items, np.int64)
    if len(items):
        out[items] = score_of(items)
        np.add.at(writes, items, 1)
    return out, writes


def score_lanes(C, share, seed):
    """score_gate's lanes with about ``share`` of the slots passing every
    gate: 0, a store's 1.4%, the synthetic lanes' 71% (weights and counts
    on the gate edges often) or 100%."""
    rng = np.random.default_rng(seed)
    u = lambda: rng.random(C, dtype=F32)
    w_ab = np.floor(u() * 20) / 4                  # 0.25 steps: on the gate
    c_ab = np.floor(u() * 20)
    w_a, w_b = u() * 50, u() * 50
    c_a = np.maximum(c_ab, np.floor(u() * 100))
    c_b = np.maximum(c_ab, np.floor(u() * 100))
    lt = rng.integers(0, 20, C).astype(np.int32)
    if share == 0.71:
        ok = rng.random(C) < 0.8
    else:
        ok = rng.random(C) < share
        w_ab = np.maximum(w_ab, F32(32.0))         # passes after decay too
        c_ab = np.maximum(c_ab, F32(1.0))
        w_a = np.maximum(w_a, F32(0.5))
        c_ab[~ok] = 0.0                            # dead slots: no count
    return (w_ab, c_ab, w_a, w_b, c_a, c_b), ok, lt


def tile_n(spec):
    return {"1": 1, "5": 5, "S-1": S - 1, "S": S, "S+3": S + 3, "2S": 2 * S,
            "3S+17": 3 * S + 17}[spec]


# C = S and 2S are whole tiles with no ragged one, as the engine's
# power-of-two capacities are.
SIZES = ["1", "5", "S-1", "S", "S+3", "2S", "3S+17"]
SHARES = [0.0, 0.014, 0.71, 1.0]


@pytest.mark.parametrize("half_life", [None, HALF_LIFE])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("size", SIZES)
def test_score_gate_tiles_equal_plain_bit_for_bit(size, share, vec,
                                                  half_life):
    C = tile_n(size)
    lanes_np, ok_np, lt_np = score_lanes(C, share, C * 7 + 2)
    t = torch.from_numpy
    lanes = [t(x) for x in lanes_np]
    sc = [torch.tensor(x, dtype=torch.float32) for x in SC]
    w_eff = lanes[0]
    if half_life is not None:
        w_eff = tk.decay_exp2(w_eff, t(lt_np), sc[2], half_life)
    exp = ref.score_gate_ref(w_eff, *lanes[1:], t(ok_np), sc[0], sc[1],
                             COEFS, **GATES).numpy()
    w = w_eff.numpy()
    passes = (ok_np & (w >= F32(GATES["min_pair_weight"]))
              & (lanes_np[1] >= F32(GATES["min_pair_count"]))
              & (lanes_np[2] >= F32(GATES["min_src_weight"])))

    def score_of(slots):
        idx = t(slots)
        return score_body(t(w[slots]), *(x[idx] for x in lanes[1:]), sc[0],
                          sc[1], COEFS).numpy()

    out, writes = replay(C, vec, passes, score_of, F32(-np.inf))
    assert (writes == 1).all()
    assert np.array_equal(out.view(np.int32), exp.view(np.int32))
    if share in (0.0, 1.0):
        assert passes.mean() == share
    elif C > 1000 and half_life is None:           # the decay lowers it
        assert abs(passes.mean() - share) < 0.05


def assoc_lanes(C, share, seed):
    """assoc_score's lanes with ``share`` of the slots at c_ab > 0; the
    others hold 0, -0.0, -1 or NaN in c_ab and inf/NaN in other lanes."""
    (w_ab, c_ab, w_a, w_b, c_a, c_b), _, _ = score_lanes(C, 0.71, seed)
    rng = np.random.default_rng(seed + 1)
    c_ab = np.maximum(c_ab, F32(1.0))
    dead = rng.random(C) >= share
    c_ab[dead] = rng.choice(np.array([0.0, -0.0, -1.0, np.nan], F32),
                            int(dead.sum()))
    for x in (w_ab, w_a, w_b, c_a, c_b):
        junk = dead & (rng.random(C) < 0.3)
        x[junk] = rng.choice(np.array([np.inf, -np.inf, np.nan], F32),
                             int(junk.sum()))
    return w_ab, c_ab, w_a, w_b, c_a, c_b


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("size", SIZES)
def test_assoc_score_tiles_equal_plain_bit_for_bit(size, share, vec):
    C = tile_n(size)
    lanes_np = assoc_lanes(C, share, C * 5 + 2)
    t = torch.from_numpy
    lanes = [t(x) for x in lanes_np]
    tot = [torch.tensor(x, dtype=torch.float32) for x in SC[:2]]
    exp = score_body(*lanes, *tot, COEFS).numpy()
    zero = torch.zeros(1)
    fill = score_body(*([zero] * 6), *tot, COEFS).numpy()[0]

    def score_of(slots):
        idx = t(slots)
        return score_body(*(x[idx] for x in lanes), *tot, COEFS).numpy()

    out, writes = replay(C, vec, lanes_np[1] > 0, score_of, fill)
    assert (writes == 1).all()
    assert np.array_equal(out.view(np.int32), exp.view(np.int32))


MARGINALS = ("w_a", "w_b", "c_a", "c_b", "total_w", "total_c")


def odd_marginal(lanes, tot, lane, value, seed):
    """Copies of ``lanes`` and ``tot`` with ``value`` in one marginal: at
    about 30% of the slots with c_ab > 0, or the whole total."""
    lanes = [x.copy() for x in lanes]
    tot = list(tot)
    if lane.startswith("total"):
        tot[lane == "total_c"] = F32(value)
    else:
        x = lanes[("w_a", "w_b", "c_a", "c_b").index(lane) + 2]
        rng = np.random.default_rng(seed)
        hit = (lanes[1] > 0) & (rng.random(x.shape[0]) < 0.3)
        x[hit] = F32(value)
    return lanes, tot


def assert_nan_where_plain_nan(out, exp):
    """NaN exactly where the plain version is NaN (any sign and payload);
    every other value bit for bit."""
    assert np.array_equal(np.isnan(out), np.isnan(exp))
    fin = ~np.isnan(exp)
    assert np.array_equal(out[fin].view(np.int32), exp[fin].view(np.int32))


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("lane", MARGINALS)
def test_score_gate_tiles_nan_inf_marginals(lane, value, vec):
    """NaN and +-inf marginals in slots with c_ab > 0 (the body's clamps
    propagate NaN, as the plain clamp_min does): the tiles give NaN exactly
    where score_gate_ref does, and its bits everywhere else."""
    C = 3 * S + 17
    lanes_np, ok_np, _ = score_lanes(C, 0.71, C + 3)
    lanes_np, tot = odd_marginal(lanes_np, SC[:2], lane, value, C)
    t = torch.from_numpy
    lanes = [t(x) for x in lanes_np]
    sc = [torch.tensor(x, dtype=torch.float32) for x in tot]
    exp = ref.score_gate_ref(*lanes, t(ok_np), sc[0], sc[1], COEFS,
                             **GATES).numpy()
    passes = (ok_np & (lanes_np[0] >= F32(GATES["min_pair_weight"]))
              & (lanes_np[1] >= F32(GATES["min_pair_count"]))
              & (lanes_np[2] >= F32(GATES["min_src_weight"])))

    def score_of(slots):
        idx = t(slots)
        return score_body(*(x[idx] for x in lanes), sc[0], sc[1],
                          COEFS).numpy()

    out, writes = replay(C, vec, passes, score_of, F32(-np.inf))
    assert (writes == 1).all()
    assert_nan_where_plain_nan(out, exp)
    if lane in ("c_a", "c_b", "total_w", "total_c") and np.isnan(value):
        assert np.isnan(out).any()


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("lane", MARGINALS)
def test_assoc_score_tiles_nan_inf_marginals(lane, value, vec):
    C = 3 * S + 17
    lanes_np = assoc_lanes(C, 0.71, C + 9)
    lanes_np, tot = odd_marginal(lanes_np, SC[:2], lane, value, C + 1)
    t = torch.from_numpy
    lanes = [t(x) for x in lanes_np]
    tot = [torch.tensor(x, dtype=torch.float32) for x in tot]
    exp = score_body(*lanes, *tot, COEFS).numpy()
    fill = score_body(*([torch.zeros(1)] * 6), *tot, COEFS).numpy()[0]

    def score_of(slots):
        idx = t(slots)
        return score_body(*(x[idx] for x in lanes), *tot, COEFS).numpy()

    out, writes = replay(C, vec, lanes_np[1] > 0, score_of, fill)
    assert (writes == 1).all()
    assert_nan_where_plain_nan(out, exp)


@pytest.mark.parametrize("junk", [np.inf, -np.inf, np.nan, "mixed"])
@pytest.mark.parametrize("c_ab", [0.0, -0.0, -1.0, np.nan])
@pytest.mark.parametrize("coefs", [COEFS, (-1.0, 0.15, 0.02, 0.3),
                                   (0.0, -2.5, 1.0, 1.0)])
def test_assoc_score_block_constant_is_score_body_on_zeros(c_ab, junk, coefs):
    """Where ``!(c_ab > 0)`` score_body zeroes all four lanes, so such a
    slot's score is the body on zeros, whatever its other lanes hold."""
    rng = np.random.default_rng(3)
    n = 64
    if junk == "mixed":
        others = rng.choice(np.array([np.inf, -np.inf, np.nan, 3.0, -2.0],
                                     F32), (5, n))
    else:
        others = np.full((5, n), junk, F32)
    w_ab, w_a, w_b, c_a, c_b = (torch.from_numpy(x) for x in others)
    cab = torch.full((n,), c_ab, dtype=torch.float32)
    for tw, tc in ((1e4, 2e4), (np.inf, np.nan), (0.0, -1.0)):
        tot = [torch.tensor(x, dtype=torch.float32) for x in (tw, tc)]
        got = score_body(w_ab, cab, w_a, w_b, c_a, c_b, *tot, coefs)
        zero = score_body(*([torch.zeros(1)] * 6), *tot, coefs)
        assert torch.equal(got.view(torch.int32),
                           zero.expand(n).view(torch.int32))


def test_route_rule():
    """The wrappers name the 16-byte route where every base is 16-byte
    aligned; a view one element into a buffer takes the 4-byte route."""
    buf = torch.zeros(65, dtype=torch.float32)
    assert buf.data_ptr() % 16 == 0
    assert tk.score_route(buf.data_ptr(), buf[4:].data_ptr()) == "vec"
    assert tk.score_route(buf.data_ptr(), buf[1:].data_ptr()) == "scalar"
    ok = torch.zeros(65, dtype=torch.bool)
    assert tk.score_route(ok.data_ptr(), ok[16:].data_ptr()) == "vec"
    assert tk.score_route(ok[4:].data_ptr()) == "scalar"


def test_tile_fits_and_masks():
    """A tile's list fits in static shared memory with eight blocks an SM;
    offsets fit in 16 bits; a thread's pass mask fits in 32 bits."""
    smem = S * 2 + S * 4 + WARPS * 4      # score_gate: offset + weight
    assert smem <= 48 * 1024
    assert SMEM_PER_SM // (smem + 1024) >= 8
    assert S - 1 <= 0xFFFF and P <= 32
    assert WARPS * 32 * P == S            # the segments cover the tile

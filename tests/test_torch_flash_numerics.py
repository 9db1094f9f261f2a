"""Why the bf16 tensor-core ``flash_attention`` is held to a wider bound.

The CUDA kernel for bf16 computes S = QK^T and O = PV on the tensor cores
(wgmma), so P is rounded to bf16 before P.V, as an MXU does with the Pallas
kernel's f32 ``dot_general`` at JAX's default precision. Its plain twin
``ref.flash_attention_ref`` keeps P in f32 and stays the function. Here the
kernel's tile algorithm runs in plain torch on the CPU (online softmax over
64-key tiles, f32 scores, the row sum ``l`` from the f32 p, p rounded to
bf16 for P.V) and is held against the twin on every shape of the CUDA
tests:

  * within the kernel's bound: rtol 2^-7 (the two final bf16 roundings),
    atol 2^-9 max|v| (each p moves by at most 2^-9 relative, so the output,
    a weighted mean of v with weights normalised by the f32 l, moves by at
    most 2^-9 max|v|), and relative RMS <= 2^-8;
  * the f32-P bar (rtol 2^-7, atol 1e-5) fails on at least one shape, so the
    wider bound is needed, and the same algorithm with P kept in f32 meets
    that bar on every shape, so rounding P is what needs it.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

# (B, Hq, Hkv, Tq, Tk, D, causal, window): tests/test_torch_cuda.py's
# FA_SHAPES (that file needs a card and is not imported here).
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
    (1, 32, 8, 1024, 1024, 80, True, 256),
]
RTOL, ATOL_V, REL_RMS = 2 ** -7, 2 ** -9, 2 ** -8
OLD_BAR = dict(rtol=2 ** -7, atol=1e-5)


def tile_attention(q, k, v, *, causal, window, p_bf16=True, bk=64):
    """The kernel's algorithm in plain torch: one pass over bk-key tiles
    with a running max m and sum l (from the f32 p) in f32, p rounded to
    bf16 for P.V when ``p_bf16``; masked scores are -inf and a row whose
    running max is still -inf adds nothing."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qf = q.float()
    kf = k.repeat_interleave(rep, dim=1).float()
    vf = v.repeat_interleave(rep, dim=1).float()
    scale = ref.attention_scale(D)
    qpos = torch.arange(Tq)[:, None] + (Tk - Tq)
    m = torch.full((B, Hq, Tq), float("-inf"))
    l = torch.zeros((B, Hq, Tq))
    o = torch.zeros((B, Hq, Tq, D))
    for kt in range(0, Tk, bk):
        ke = min(kt + bk, Tk)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, kt:ke]) * scale
        kpos = torch.arange(kt, ke)[None, :]
        ok = torch.ones((Tq, ke - kt), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= kpos > qpos - window
        s = s.masked_fill(~ok, float("-inf"))
        mn = torch.maximum(m, s.amax(-1))
        live = mn > float("-inf")
        corr = torch.where(live, torch.exp(m - mn), torch.ones(()))
        p = torch.where(live[..., None], torch.exp(s - mn[..., None]),
                        torch.zeros(()))
        l = l * corr + p.sum(-1)
        pv = p.bfloat16().float() if p_bf16 else p
        o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", pv,
                                               vf[:, :, kt:ke])
        m = mn
    out = torch.where(l[..., None] > 0, o / l[..., None], torch.zeros(()))
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _run(shape, p_bf16=True):
    """(tile result, twin result, v) in f32 for bf16 inputs made with numpy
    from a seed, q/k/v as [B, H, T, D] views of [B, T, H, D] tensors."""
    B, Hq, Hkv, Tq, Tk, D, causal, window = shape
    rng = np.random.default_rng(sum(shape[:6]))

    def make(T, H):
        x = torch.from_numpy(rng.standard_normal((B, T, H, D),
                                                 dtype=np.float32))
        return x.bfloat16().transpose(1, 2)
    q, k, v = make(Tq, Hq), make(Tk, Hkv), make(Tk, Hkv)
    got = tile_attention(q, k, v, causal=causal, window=window,
                         p_bf16=p_bf16)
    exp = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return got.float(), exp.float(), v.float()


def _meets(got, exp, rtol, atol):
    return bool(((got - exp).abs() <= atol + rtol * exp.abs()).all())


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
def test_bf16_p_tiles_meet_the_kernel_bound(shape):
    got, exp, v = _run(shape)
    torch.testing.assert_close(got, exp, rtol=RTOL,
                               atol=ATOL_V * float(v.abs().max()))
    rms = float((got - exp).norm() / exp.norm())
    assert rms <= REL_RMS, f"relative RMS {rms} > 2^-8"


def test_bf16_p_fails_the_f32_p_bar_on_some_shape():
    failing = [s for s in FA_SHAPES if not _meets(*_run(s)[:2], **OLD_BAR)]
    assert failing, "the f32-P bar holds on every shape: no wider bound needed"


@pytest.mark.parametrize("shape", FA_SHAPES, ids=str)
def test_f32_p_tiles_meet_the_f32_p_bar(shape):
    got, exp, _ = _run(shape, p_bf16=False)
    torch.testing.assert_close(got, exp, **OLD_BAR)

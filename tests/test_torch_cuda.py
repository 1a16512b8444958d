"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here launches a kernel, carries the ``cuda`` marker and skips
without a GPU. The file imports no JAX, so it also runs on a machine that has
only PyTorch: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py`` (the repository's conftest imports JAX).
Tolerances as in ``chip_smoke.py``: 1e-4 relative for the Q8 forms and the
probes, one bf16 ulp for the residual epilogue (in the GEMV's rows test,
bitwise against the kernel's own accumulator), one bf16 ulp or 1e-4 of
max|ref| for ``fused_gateup_silu``,
1e-3 relative for ``fused_ffn_step``, 5e-3 for attention (stacked, unstacked,
batched and flash prefill), bitwise on integers.
"""

import numpy as np
import pytest
import torch

from light_whisper_tpu_torch.formats.gguf import quantize_q8_0
from light_whisper_tpu_torch.ops import decode_attention as da
from light_whisper_tpu_torch.ops import flash_prefill as fp
from light_whisper_tpu_torch.ops import fused_ffn as ffn
from light_whisper_tpu_torch.ops import q8_matmul as q8
from light_whisper_tpu_torch.scripts import exp_q8_compute_bound as cb
from light_whisper_tpu_torch.scripts import exp_q8_kperm_probe as kp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _weights(L, out_f, in_f, seed, device):
    rng = np.random.default_rng(seed)
    qs, ss = zip(*(quantize_q8_0((rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)).astype(np.float32))
                   for _ in range(L)))
    q = torch.from_numpy(np.stack(qs)).to(device)
    s = torch.from_numpy(np.stack(ss)).to(torch.bfloat16).to(device)
    return q, s


def _close(got, want, rel=1e-4):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= rel * max(1.0, float(want.abs().max())), err


@pytest.mark.parametrize("T", [1, 5, 64, 130])
def test_stacked_form(cuda, T):
    q, s = _weights(2, 512, 1024, seed=T, device=cuda)
    x = torch.randn(T, 1024, device=cuda).to(torch.bfloat16)
    before = q8.LAUNCHES["q8_matmul_stacked"]
    got = q8.q8_matmul_stacked(x, q, s, 1)
    assert q8.LAUNCHES["q8_matmul_stacked"] == before + 1
    _close(got, q8.q8_matmul_plain(x, q[1], s[1]))


@pytest.mark.parametrize("T,N", [(1, 4000), (70, 300)])
def test_2d_form_with_ragged_edges(cuda, T, N):
    q, s = _weights(1, N, 512, seed=N, device=cuda)
    x = torch.randn(T, 512, device=cuda)
    before = q8.LAUNCHES["q8_matmul"]
    got = q8.q8_matmul(x, q[0], s[0])
    assert q8.LAUNCHES["q8_matmul"] == before + 1
    _close(got, q8.q8_matmul_plain(x, q[0], s[0]))


@pytest.mark.parametrize("with_norm,with_residual", [(True, False), (False, True)])
def test_fused_form(cuda, with_norm, with_residual):
    q, s = _weights(2, 1024, 1024, seed=3, device=cuda)
    x = torch.randn(2, 1024, device=cuda).to(torch.bfloat16)
    norm_w = 1.0 + 0.1 * torch.randn(1024, device=cuda) if with_norm else None
    res = torch.randn(2, 1024, device=cuda).to(torch.bfloat16) if with_residual else None
    before = q8.LAUNCHES["q8_matmul_stacked_fused"]
    got = q8.q8_matmul_stacked_fused(x, q, s, 1, norm_w=norm_w, residual=res)
    assert q8.LAUNCHES["q8_matmul_stacked_fused"] == before + 1
    want = q8.q8_matmul_fused_plain(x, q[1], s[1], norm_w, 1e-6, res)
    if with_residual:
        torch.cuda.synchronize()
        acc = q8.q8_matmul_fused_plain(x, q[1], s[1], None, 1e-6, None)
        mag = torch.maximum(want.abs(), acc.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert bool(((got - want).abs() <= ulp * 1.0001).all())
    else:
        _close(got, want, rel=1e-3)


def test_integer_values_are_bitwise(cuda):
    q = torch.randint(-127, 128, (2, 256, 512), device=cuda, dtype=torch.int8)
    s = torch.full((2, 256, 16), 0.5, device=cuda, dtype=torch.bfloat16)
    for T in (3, 40):
        x = torch.randint(-4, 4, (T, 512), device=cuda).to(torch.bfloat16)
        torch.testing.assert_close(q8.q8_matmul_stacked(x, q, s, 1), q8.q8_matmul_plain(x, q[1], s[1]),
                                   rtol=0, atol=0)


def test_operands_on_another_device_are_refused(cuda):
    q, s = _weights(1, 256, 512, seed=0, device="cpu")
    with pytest.raises(ValueError, match="on cpu"):
        q8.q8_matmul(torch.randn(1, 512, device=cuda), q[0], s[0])


@pytest.mark.parametrize("T,start", [(1, 0), (1, 500), (7, 33), (64, 300)])
def test_decode_attention(cuda, T, start):
    L, Hq, Hkv, C, hd = 2, 4, 2, 1024, 128
    kc = torch.randn(L, Hkv, C, hd, device=cuda).to(torch.bfloat16)
    vc = torch.randn(L, Hkv, C, hd, device=cuda).to(torch.bfloat16)
    qx = torch.randn(T, Hq, hd, device=cuda) * 2
    before = da.LAUNCHES["decode_attention"]
    got = da.decode_attention(qx, kc, vc, start, 1)
    assert da.LAUNCHES["decode_attention"] == before + 1
    torch.testing.assert_close(got, da.decode_attention_plain(qx, kc, vc, start, 1), atol=5e-3, rtol=0)


def test_attention_refuses_positions_past_the_cache(cuda):
    kc = torch.zeros(1, 2, 64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceed"):
        da.decode_attention(torch.zeros(4, 4, 128, device=cuda), kc, kc, 62, 0)


@pytest.mark.parametrize("T,start", [(1, 0), (64, 300)])
def test_decode_attention_unstacked(cuda, T, start):
    kc = torch.randn(2, 1024, 128, device=cuda).to(torch.bfloat16)
    vc = torch.randn(2, 1024, 128, device=cuda).to(torch.bfloat16)
    qx = torch.randn(T, 4, 128, device=cuda) * 2
    before = da.LAUNCHES["decode_attention_unstacked"]
    got = da.decode_attention_unstacked(qx, kc, vc, start)
    assert da.LAUNCHES["decode_attention_unstacked"] == before + 1
    torch.testing.assert_close(got, da.attention_plain(qx, kc, vc, start), atol=5e-3, rtol=0)


@pytest.mark.parametrize("positions", [[0, 37], [5, 1023, 511, 0, 64, 700, 1, 999]])
def test_decode_attention_batched(cuda, positions):
    """Mixed positions with junk past each one (the padded prompt tails)."""
    B, L, Hq, Hkv, C, hd = len(positions), 3, 16, 8, 1024, 128
    kc = torch.randn(B, L, Hkv, C, hd, device=cuda).to(torch.bfloat16)
    vc = torch.randn(B, L, Hkv, C, hd, device=cuda).to(torch.bfloat16)
    for b, p in enumerate(positions):
        kc[b, :, :, p + 1:] = 1e4
        vc[b, :, :, p + 1:] = -1e4
    qx = torch.randn(B, Hq, hd, device=cuda) * 2
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    before = da.LAUNCHES["decode_attention_batched"]
    got = da.decode_attention_batched(qx, kc, vc, pos, 1, positions)
    assert da.LAUNCHES["decode_attention_batched"] == before + 1
    torch.testing.assert_close(got, da.decode_attention_batched_plain(qx, kc, vc, pos, 1), atol=5e-3, rtol=0)
    assert bool(torch.isfinite(got).all())



def _held(got, split_want, want):
    """Within 5e-3 of the split plain version at the kernel's split count
    (the f32 sums run in another order inside a split, which may move l by an
    ulp and flip one bf16 p) and of the unsplit plain version."""
    torch.testing.assert_close(got, split_want, atol=5e-3, rtol=0)
    torch.testing.assert_close(got, want, atol=5e-3, rtol=0)
    assert bool(torch.isfinite(got).all())


def _split_edges():
    splits = da.split_count(1024)
    return [splits - 2, 3 * splits - 2, 3 * splits]  # live keys < S, = 3S - 1, = 3S + 1


@pytest.mark.parametrize("start", _split_edges())
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_attention_split_edges(cuda, start, hd):
    """T=1 (two rows a KV head, CUDA cores) where the live keys do not fill
    the cluster's splits evenly, at every head dim the kernel takes."""
    kc = torch.randn(2, 1024, hd, device=cuda).to(torch.bfloat16)
    vc = torch.randn(2, 1024, hd, device=cuda).to(torch.bfloat16)
    kc[:, start + 1:] = 1e4  # junk past the position must not leak in
    vc[:, start + 1:] = -1e4
    qx = torch.randn(1, 4, hd, device=cuda) * 2
    before = da.LAUNCHES["decode_attention_unstacked"]
    got = da.decode_attention_unstacked(qx, kc, vc, start)
    assert da.LAUNCHES["decode_attention_unstacked"] == before + 1
    splits = da.split_count(1024)
    _held(got, da.attention_split_plain(qx, kc, vc, start, splits), da.attention_plain(qx, kc, vc, start))


@pytest.mark.parametrize("T,start,C,hd", [(1, 32767, 32768, 128), (64, 960, 1024, 128), (8, 100, 1024, 128),
                                          (64, 0, 1024, 64), (16, 500, 1024, 256)])
def test_decode_attention_split_at_0_6b_heads(cuda, T, start, C, hd):
    """16 query / 8 KV heads: the longest single-pass context, the 128-row
    tensor-core units (two row tiles), a 16-row unit in a 16-CTA cluster, and
    head dims 64 and 256 on the tensor cores."""
    kc = torch.randn(2, 8, C, hd, device=cuda).to(torch.bfloat16)
    vc = torch.randn(2, 8, C, hd, device=cuda).to(torch.bfloat16)
    qx = torch.randn(T, 16, hd, device=cuda) * 2
    before = da.LAUNCHES["decode_attention"]
    got = da.decode_attention(qx, kc, vc, start, 1)
    assert da.LAUNCHES["decode_attention"] == before + 1
    splits = da.split_count(C)
    _held(got, da.attention_split_plain(qx, kc[1], vc[1], start, splits),
          da.decode_attention_plain(qx, kc, vc, start, 1))


def test_decode_attention_batched_split(cuda):
    """B=8 with streams at position 0 and at C-1, junk past each position."""
    positions = [0, 4095, 37, 2048, 1, 4000, 64, 63]
    B, L, Hq, Hkv, C, hd = len(positions), 2, 16, 8, 4096, 128
    kc = torch.randn(B, L, Hkv, C, hd, device=cuda).to(torch.bfloat16)
    vc = torch.randn(B, L, Hkv, C, hd, device=cuda).to(torch.bfloat16)
    for b, p in enumerate(positions):
        kc[b, :, :, p + 1:] = 1e4
        vc[b, :, :, p + 1:] = -1e4
    qx = torch.randn(B, Hq, hd, device=cuda) * 2
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    before = da.LAUNCHES["decode_attention_batched"]
    got = da.decode_attention_batched(qx, kc, vc, pos, 1, positions)
    assert da.LAUNCHES["decode_attention_batched"] == before + 1
    splits = da.split_count(C)
    _held(got, da.decode_attention_batched_split_plain(qx, kc, vc, pos, 1, splits),
          da.decode_attention_batched_plain(qx, kc, vc, pos, 1))


def test_batched_attention_needs_device_int32_positions(cuda):
    kc = torch.zeros(2, 1, 2, 64, 128, device=cuda, dtype=torch.bfloat16)
    q = torch.zeros(2, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention_batched(q, kc, kc, torch.tensor([1, 2], device=cuda), 0, [1, 2])
    with pytest.raises(ValueError, match="exceed"):
        da.decode_attention_batched(q, kc, kc, torch.tensor([1, 64], dtype=torch.int32, device=cuda), 0, [1, 64])


def test_fused_form_at_eight_rows_and_48_kb_of_staged_input(cuda):
    """B = 8 batched decode of the down projection: 8 x 3072 bf16 rows fill the
    48 KB default shared memory before the kernel's own arrays."""
    q, s = _weights(2, 1024, 3072, seed=5, device=cuda)
    x = torch.randn(8, 3072, device=cuda).to(torch.bfloat16)
    res = torch.randn(8, 1024, device=cuda).to(torch.bfloat16)
    got = q8.q8_matmul_stacked_fused(x, q, s, 1, residual=res)
    acc = q8.q8_matmul_fused_plain(x, q[1], s[1], None, 1e-6, None)
    want = q8.q8_matmul_fused_plain(x, q[1], s[1], None, 1e-6, res)
    torch.cuda.synchronize()
    mag = torch.maximum(want.abs(), acc.abs()).clamp_min(1e-30)
    assert bool(((got - want).abs() <= torch.exp2(torch.floor(torch.log2(mag)) - 7) * 1.0001).all())


@pytest.mark.parametrize("T,Hq,Hkv,C,start", [(65, 16, 8, 8192, 0), (130, 4, 2, 8192, 4000),
                                              (12, 6, 2, 1024, 1012), (300, 16, 8, 8192, 7892)])
def test_flash_prefill(cuda, T, Hq, Hkv, C, start):
    """Against its plain version at the kernel's key tile; junk past the last
    position must not leak in, and ragged row and key edges are masked."""
    kc = torch.randn(Hkv, C, 128, device=cuda).to(torch.bfloat16)
    vc = torch.randn(Hkv, C, 128, device=cuda).to(torch.bfloat16)
    kc[:, start + T:] = 1e4
    vc[:, start + T:] = -1e4
    qx = (torch.randn(T, Hq, 128, device=cuda) * 2).to(torch.bfloat16)
    before = fp.LAUNCHES["flash_prefill"]
    got = fp.flash_prefill(qx, kc, vc, start)
    assert fp.LAUNCHES["flash_prefill"] == before + 1
    torch.testing.assert_close(got, fp.flash_prefill_plain(qx, kc, vc, start), atol=5e-3, rtol=0)
    assert bool(torch.isfinite(got).all())


def test_flash_prefill_refuses_positions_past_the_cache(cuda):
    kc = torch.zeros(2, 1024, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceed"):
        fp.flash_prefill(torch.zeros(100, 4, 128, device=cuda, dtype=torch.bfloat16), kc, kc, 1000)


# (T, Hq, Hkv, C, start): G = 1, 2, 4; T not a multiple of the 128-row tile; shares of the
# visible keys whose last one ends mid-share, and (T=3) fewer visible keys than shares
FLASH_SPLIT_EDGES = [(100, 8, 8, 8192, 1000), (200, 16, 8, 8192, 7000), (97, 16, 4, 8192, 5), (3, 8, 2, 8192, 0),
                     (128, 16, 8, 8192, 8064), (512, 16, 8, 32768, 32768 - 512)]


@pytest.mark.parametrize("T,Hq,Hkv,C,start", FLASH_SPLIT_EDGES)
def test_flash_prefill_split_edges(cuda, T, Hq, Hkv, C, start):
    """The cluster key split: within 5e-3 of the split schedule in torch at
    the kernel's own split count and of the unsplit plain version, junk past
    the last position kept out, and bitwise the same run to run."""
    kc = torch.randn(Hkv, C, 128, device=cuda).to(torch.bfloat16)
    vc = torch.randn(Hkv, C, 128, device=cuda).to(torch.bfloat16)
    kc[:, start + T:] = 1e4
    vc[:, start + T:] = -1e4
    qx = (torch.randn(T, Hq, 128, device=cuda) * 2).to(torch.bfloat16)
    splits, clusters = fp.plan(T, Hq, Hkv, C)
    assert splits == fp.prefill_splits(T, Hq, Hkv, C) and clusters >= 1
    before = fp.LAUNCHES["flash_prefill"]
    got = fp.flash_prefill(qx, kc, vc, start)
    again = fp.flash_prefill(qx, kc, vc, start)
    assert fp.LAUNCHES["flash_prefill"] == before + 2
    _held(got, fp.flash_prefill_split_plain(qx, kc, vc, start, splits), fp.flash_prefill_plain(qx, kc, vc, start))
    assert torch.equal(got, again)


def _ffn_weights(D, F, device, seed=7):
    gq, gs = _weights(2, 2 * F, D, seed=seed, device=device)
    dq, ds = _weights(2, D, F, seed=seed + 1, device=device)
    return gq, gs, dq, ds


def _within_one_ulp(got, want):
    """One bf16 ulp of each value, or 1e-4 of max|want| where the value
    comes out of a cancelling sum (the f32 sums run in another order)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    tol = torch.maximum(torch.exp2(torch.floor(torch.log2(mag)) - 7) * 1.0001, 1e-4 * want.abs().max())
    assert bool(((got - want).abs() <= tol).all()), float(((got - want).abs() / tol).max())


@pytest.mark.parametrize("T", [1, 3, 8])
def test_fused_ffn_step(cuda, T):
    """0.6B widths (D = 1024, F = 3072), both layers, twice each (the grid
    barrier's count is reused); 1e-3 of max|ref| against the plain version
    at the kernel's tile (the rsqrt and the bf16 rounding of ``inner``)."""
    D, F = 1024, 3072
    gq, gs, dq, ds = _ffn_weights(D, F, cuda)
    x = (torch.randn(T, D, device=cuda) * 3).to(torch.bfloat16)
    norm_w = 1.0 + 0.1 * torch.randn(D, device=cuda)
    before = ffn.LAUNCHES["fused_ffn_step"]
    for layer in (0, 1, 0, 1):
        got = ffn.fused_ffn_step(x, norm_w, gq, gs, dq, ds, layer)
        assert got.dtype == torch.float32 and got.shape == (T, D)
        _close(got, ffn.fused_ffn_step_plain(x, norm_w, gq, gs, dq, ds, layer), rel=1e-3)
    assert ffn.LAUNCHES["fused_ffn_step"] == before + 4


def test_fused_gateup_silu(cuda):
    D, F = 1024, 3072
    gq, gs, _dq, _ds = _ffn_weights(D, F, cuda)
    h = torch.randn(8, D, device=cuda).to(torch.bfloat16)
    before = ffn.LAUNCHES["fused_gateup_silu"]
    got = ffn.fused_gateup_silu(h, gq, gs, 1)
    assert ffn.LAUNCHES["fused_gateup_silu"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (8, F)
    _within_one_ulp(got, ffn.fused_gateup_silu_plain(h, gq, gs, 1))


@pytest.mark.parametrize("T,N,K", [(1, 4096, 1024), (8, 1024, 3072), (12, 300, 512), (8, 300, 512)])
def test_probe_variants(cuda, T, N, K):
    """noscale within 1e-4 relative of its plain and its split plain version
    (the GEMV's four K splits); load bitwise (integer sums)."""
    q, s = _weights(1, N, K, seed=K, device=cuda)
    x = torch.randn(T, K, device=cuda).to(torch.bfloat16)
    before = cb.LAUNCHES["q8_probe"]
    got = cb.q8_probe("noscale", x, q[0], s[0])
    _close(got, cb.noscale_plain(x, q[0]))
    _close(got, cb.noscale_split_plain(x, q[0]))
    got = cb.q8_probe("load", x, q[0], s[0])
    torch.testing.assert_close(got, cb.load_plain(q[0], T), rtol=0, atol=0)
    assert cb.LAUNCHES["q8_probe"] == before + 2


@pytest.mark.parametrize("T,N,K,block_k", [(1, 6144, 1024, 512), (8, 1024, 3072, 512), (5, 256, 2048, 2048),
                                           (8, 6144, 2048, 2048), (12, 300, 1024, 512), (3, 256, 1024, 256)])
def test_perm_matmul(cuda, T, N, K, block_k):
    """The k-permuted product within 1e-4 relative of the natural one and of
    its split plain version (block_k 256: the scales one at a time, not a
    16-wide window)."""
    q, s = _weights(2, N, K, seed=N, device=cuda)
    qp = kp.permute_kaxis(q, block_k).contiguous()
    x = torch.randn(T, K, device=cuda).to(torch.bfloat16)
    before = dict(kp.LAUNCHES)
    _close(kp.q8_matmul_perm(x, qp[1], s[1], block_k), q8.q8_matmul_plain(x, q[1], s[1]))
    xp = kp.permute_kaxis(x, block_k).contiguous()
    got = kp.q8_matmul_stacked_perm_2d(xp, qp, s, 0, block_k)
    _close(got, q8.q8_matmul_plain(x, q[0], s[0]))
    _close(got, kp.q8_matmul_perm_split_plain(xp, qp[0], s[0], block_k))
    assert kp.LAUNCHES == {"q8_matmul_perm": before["q8_matmul_perm"] + 1,
                           "q8_matmul_stacked_perm": before["q8_matmul_stacked_perm"] + 1}


@pytest.mark.parametrize("block_k", [512, 2048])
def test_probe_rows_are_the_same_batched_and_alone(cuda, block_k):
    """The probes run the shipped GEMV's instructions at every T: each row of
    a T=8 call is bitwise the row called alone."""
    N, K = 1024, 2048
    q, s = _weights(1, N, K, seed=block_k, device=cuda)
    qp = kp.permute_kaxis(q[0], block_k).contiguous()
    x = torch.randn(8, K, device=cuda).to(torch.bfloat16)
    for call in (lambda rows: cb.q8_probe("noscale", rows, q[0], s[0]),
                 lambda rows: kp.q8_matmul_perm_2d(rows, qp, s[0], block_k)):
        batched = call(x)
        alone = torch.cat([call(x[t:t + 1]) for t in range(8)])
        torch.cuda.synchronize()
        assert torch.equal(batched, alone)


# -- the redesigned Q8 kernels at their edges: the GEMV (T <= 8) on the tensor
# cores with a fixed 4-way K split, the tile kernel (T > 8) with a cluster K split


def _held_q8(got, x, q, s, T, N, K):
    """1e-4 of max|ref| from the plain version and from the kernel's split schedule."""
    splits = q8.schedule_splits(T, N, K)
    _close(got, q8.q8_matmul_split_plain(x, q, s, splits))
    _close(got, q8.q8_matmul_plain(x, q, s))


@pytest.mark.parametrize("T,N,K", [(9, 1000, 1024), (65, 1000, 1024), (6656, 896, 7680), (65, 896, 7680),
                                   (9, 896, 7680), (200, 130, 1056), (70, 4096, 1024), (96, 6144, 1024)])
def test_tile_kernel_edges(cuda, T, N, K):
    """Ragged row tiles (T = 9, 65), N off the 64-wide tile, K = 7680 over the
    cluster's split edges, a ragged last K chunk (1056), and S = 1/2/4/8."""
    q, s = _weights(1, N, K, seed=T + N, device=cuda)
    x = torch.randn(T, K, device=cuda).to(torch.bfloat16)
    before = q8.LAUNCHES["q8_matmul"]
    got = q8.q8_matmul(x, q[0], s[0])
    assert q8.LAUNCHES["q8_matmul"] == before + 1
    assert got.shape == (T, N) and got.dtype == torch.float32
    _held_q8(got, x, q[0], s[0], T, N, K)


@pytest.mark.parametrize("with_norm,with_residual", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["plain", "norm", "residual", "both"])
@pytest.mark.parametrize("T", list(range(1, 9)))
def test_gemv_rows_one_to_eight(cuda, T, with_norm, with_residual):
    """Every T the GEMV takes, with and without the prologue and the epilogue,
    at the decoder's down shape (K = 3072: three register batches a warp).

    Inputs come from a generator seeded by the case. With the residual, two
    exact checks: the kernel's own accumulator (the same call without the
    residual) against the plain one within the slack, and the output, bitwise,
    against bf16(res + bf16(that accumulator)) summed in f32, as the epilogue
    rounds. (Held against the plain output instead, a bf16(acc) one ulp apart
    can put the two sums on round-to-nearest-even ties that round apart: two
    output ulps.)"""
    N, K = 1024, 3072
    q, s = _weights(2, N, K, seed=T, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1000 * T + 10 * with_norm + with_residual)
    x = torch.randn(T, K, device=cuda, generator=gen).to(torch.bfloat16)
    norm_w = 1.0 + 0.1 * torch.randn(K, device=cuda, generator=gen) if with_norm else None
    res = torch.randn(T, N, device=cuda, generator=gen).to(torch.bfloat16) if with_residual else None
    got = q8.q8_matmul_stacked_fused(x, q, s, 1, norm_w=norm_w, residual=res)
    acc = q8.q8_matmul_stacked_fused(x, q, s, 1, norm_w=norm_w) if with_residual else got
    torch.cuda.synchronize()
    for splits in (None, q8.GEMV_SPLITS):
        _close(acc, q8.q8_matmul_fused_plain(x, q[1], s[1], norm_w, 1e-6, None, splits=splits),
               rel=1e-3 if with_norm else 1e-4)
    if with_residual:
        want = (res.float() + acc.to(torch.bfloat16).float()).to(torch.bfloat16).float()
        assert torch.equal(got, want), float((got - want).abs().max())


def test_gemv_rows_are_independent_bitwise(cuda):
    """Each row of a T = 2, 4, 8 call equals a T = 1 call on that row alone,
    with the norm and the residual on: the GEMV sums in one order for every T."""
    N, K = 4096, 1024
    q, s = _weights(2, N, K, seed=1, device=cuda)
    x = torch.randn(8, K, device=cuda).to(torch.bfloat16)
    res = torch.randn(8, N, device=cuda).to(torch.bfloat16)
    norm_w = 1.0 + 0.1 * torch.randn(K, device=cuda)
    for T in (2, 4, 8):
        rows = q8.q8_matmul_stacked_fused(x[:T], q, s, 1, norm_w=norm_w, residual=res[:T])
        for t in range(T):
            alone = q8.q8_matmul_stacked_fused(x[t:t + 1], q, s, 1, norm_w=norm_w, residual=res[t:t + 1])
            torch.testing.assert_close(rows[t:t + 1], alone, rtol=0, atol=0)


@pytest.mark.parametrize("N,K", [(4096, 1024), (1024, 3072), (896, 7680)])
def test_tile_rows_are_independent_bitwise(cuda, N, K):
    """The rows of a T = 64 call equal the same rows inside a T = 192 call,
    in the first row tile and in the second."""
    q, s = _weights(1, N, K, seed=2, device=cuda)
    x = torch.randn(192, K, device=cuda).to(torch.bfloat16)
    whole = q8.q8_matmul(x, q[0], s[0])
    for lo in (0, 64):
        torch.testing.assert_close(whole[lo:lo + 64], q8.q8_matmul(x[lo:lo + 64], q[0], s[0]), rtol=0, atol=0)


@pytest.mark.parametrize("T,N,K", [(1, 1024, 1024), (8, 1024, 3072), (9, 1024, 3072), (96, 1024, 1024),
                                   (6656, 896, 7680)])
def test_q8_integer_values_are_bitwise_on_both_kernels(cuda, T, N, K):
    q = torch.randint(-127, 128, (N, K), device=cuda, dtype=torch.int8)
    s = torch.full((N, K // 32), 0.5, device=cuda, dtype=torch.bfloat16)
    x = torch.randint(-4, 4, (T, K), device=cuda).to(torch.bfloat16)
    got = q8.q8_matmul(x, q, s)
    torch.testing.assert_close(got, q8.q8_matmul_plain(x, q, s), rtol=0, atol=0)
    torch.testing.assert_close(got, q8.q8_matmul_split_plain(x, q, s, q8.schedule_splits(T, N, K)), rtol=0, atol=0)


def test_tile_plan_agrees_with_the_kernel(cuda):
    """The kernel's own split rule gives tile_splits' values, and the card
    holds at least one cluster of each."""
    for N, K in [(4096, 1024), (1024, 2048), (6144, 1024), (1024, 3072), (3584, 896), (896, 7680)]:
        assert q8.resident_clusters(N, K) >= 1


@pytest.fixture(scope="module")
def ffn_1_7b():
    """Qwen3-ASR 1.7B's decoder FFN widths (D = 2048, F = 6144), two layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _ffn_weights(2048, 6144, torch.device("cuda"), seed=11)


@pytest.mark.parametrize("T", range(1, 9))
def test_fused_ffn_step_at_1_7b_widths(ffn_1_7b, T):
    """Two down row groups a CTA (~101 KB of shared memory): within 1e-3 of
    max|ref| of the plain version, and bitwise the same run to run."""
    gq, gs, dq, ds = ffn_1_7b
    x = (torch.randn(T, 2048, device="cuda") * 3).to(torch.bfloat16)
    norm_w = 1.0 + 0.1 * torch.randn(2048, device="cuda")
    before = ffn.LAUNCHES["fused_ffn_step"]
    got = ffn.fused_ffn_step(x, norm_w, gq, gs, dq, ds, 1)
    again = ffn.fused_ffn_step(x, norm_w, gq, gs, dq, ds, 1)
    assert ffn.LAUNCHES["fused_ffn_step"] == before + 2
    _close(got, ffn.fused_ffn_step_plain(x, norm_w, gq, gs, dq, ds, 1), rel=1e-3)
    assert torch.equal(got, again)


@pytest.mark.parametrize("D,F", [(1024, 3072), (2048, 6144)])
def test_fused_ffn_rows_are_independent_bitwise(cuda, D, F):
    """Row t of a T = 8 call equals the T = 1 call on that row, bit for bit:
    T = 1 runs T = 8's instructions with zero rows, every sum in one order."""
    gq, gs, dq, ds = _ffn_weights(D, F, cuda, seed=13)
    x = (torch.randn(8, D, device=cuda) * 3).to(torch.bfloat16)
    norm_w = 1.0 + 0.1 * torch.randn(D, device=cuda)
    rows = ffn.fused_ffn_step(x, norm_w, gq, gs, dq, ds, 0)
    alone = torch.cat([ffn.fused_ffn_step(x[t:t + 1], norm_w, gq, gs, dq, ds, 0) for t in range(8)])
    assert torch.equal(rows, alone)
    inner = ffn.fused_gateup_silu(x, gq, gs, 0)
    assert torch.equal(inner, torch.cat([ffn.fused_gateup_silu(x[t:t + 1], gq, gs, 0) for t in range(8)]))


@pytest.mark.parametrize("T", [1, 8])
def test_fused_gateup_silu_at_1_7b_widths(ffn_1_7b, T):
    gq, gs, _dq, _ds = ffn_1_7b
    h = torch.randn(T, 2048, device="cuda").to(torch.bfloat16)
    _within_one_ulp(ffn.fused_gateup_silu(h, gq, gs, 0), ffn.fused_gateup_silu_plain(h, gq, gs, 0))


def test_fused_ffn_step_refuses_f_not_a_multiple_of_64(cuda):
    gq, gs, dq, ds = _ffn_weights(64, 96, cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        ffn.fused_ffn_step(torch.zeros(1, 64, device=cuda), torch.ones(64, device=cuda), gq, gs, dq, ds, 0)


# -- the decode step as a captured CUDA graph -------------------------------------------

GRAPH_BUDGET = 24


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    """The multi-device dry run's serving model (heads of 128, Q8_0), random
    from seed 0, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from light_whisper_tpu_torch.models.qwen3_asr import synthetic
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
    from light_whisper_tpu_torch.parallel.dryrun import tiny_config

    path = str(tmp_path_factory.mktemp("graph") / "tiny-q8.gguf")
    synthetic.write_model(path, tiny_config(), seed=0, quantize=True)
    return Qwen3ASRModel(path, device="cuda", max_new_tokens=GRAPH_BUDGET)


def _launch_counts():
    return {**q8.LAUNCHES, **da.LAUNCHES, **fp.LAUNCHES, **ffn.LAUNCHES}


def _span_counts():
    from light_whisper_tpu_torch.runtime import tracing

    snap = tracing.snapshot()
    return {n: snap.get(n, {"count": 0})["count"] for n in ("model.decode.step", "model.decode.capture",
                                                             "model.decode.replay")}


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def _run(fn, graphs: bool, monkeypatch):
    """``fn()`` with the step captured (the card's default) or eager; its
    result, the launches it counted and the spans it added."""
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    with monkeypatch.context() as m:
        if not graphs:
            m.setattr(dec, "graphs_engage", lambda *args: False)
        launches, spans = _launch_counts(), _span_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, _delta(launches, _launch_counts()), _delta(spans, _span_counts())


def _prompt_cache(model, seed, batch=None):
    """A decoder cache after a prompt of random embeddings: one stream's
    ``KVCache`` (``batch`` None) or ``batch`` streams' ``BatchKVCache``."""
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    cfg = model.config.decoder
    gen = torch.Generator().manual_seed(seed)
    if batch is None:
        cache = dec.init_cache(cfg, 1024, device="cuda")
        embeds = torch.randn(40, cfg.embedding_length, generator=gen).to("cuda", torch.bfloat16)
        hidden = dec.forward(cfg, model.decoder_params, embeds, cache)
        return cache, torch.argmax(dec.logits_for(cfg, model.decoder_params, hidden[-1:])[-1])
    cache = dec.init_cache_batch(cfg, batch, 1024, device="cuda")
    embeds = torch.randn(batch, 40, cfg.embedding_length, generator=gen).to("cuda", torch.bfloat16)
    hidden = dec.forward_prefill_batch(cfg, model.decoder_params, embeds, cache)
    cache.set_positions([40 - 3 * b for b in range(batch)])  # streams at their own positions
    return cache, torch.argmax(dec.logits_for(cfg, model.decoder_params, hidden[:, -1]), dim=-1)


def _clone(cache):
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    if isinstance(cache, dec.KVCache):
        return dec.KVCache(k=cache.k.clone(), v=cache.v.clone(), pos=cache.pos)
    out = dec.BatchKVCache(k=cache.k.clone(), v=cache.v.clone(), pos=torch.zeros(0), pos_host=[])
    out.set_positions(cache.pos_host)
    return out


@pytest.mark.parametrize("budget", [None, 9])
def test_graph_loop_b1_matches_the_eager_loops(tiny_model, monkeypatch, budget):
    """The captured B=1 loop gives the eager batched step's ids, cache and
    launches, and the ids and cache of the single-stream ``forward`` loop it
    replaced (the batched attention at B=1 takes the stacked one's split)."""
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    cfg, params = tiny_model.config.decoder, tiny_model.decoder_params
    cache, first = _prompt_cache(tiny_model, seed=1)
    caches = [_clone(cache), _clone(cache), _clone(cache)]
    eos = -1

    def loop(c):
        return lambda: dec.decode_greedy(cfg, params, first, c, eos, GRAPH_BUDGET, budget=budget)

    got, launches, spans = _run(loop(caches[0]), True, monkeypatch)
    eager, eager_launches, eager_spans = _run(loop(caches[1]), False, monkeypatch)
    steps = (budget or GRAPH_BUDGET) - 1
    assert got == eager and len(got) == steps + 1
    assert spans == {"model.decode.step": steps, "model.decode.capture": 1, "model.decode.replay": steps}
    assert eager_spans["model.decode.capture"] == eager_spans["model.decode.replay"] == 0
    assert launches == eager_launches and launches["decode_attention_batched"] == cfg.block_count * steps
    assert launches["decode_attention"] == 0
    old, token = caches[2], first.reshape(1)
    want = [int(first)]
    for _ in range(steps):
        hidden = dec.forward(cfg, params, dec.embed_tokens(params, token), old)
        token = torch.argmax(dec.logits_for(cfg, params, hidden[-1:])[-1]).reshape(1)
        want.append(int(token))
    assert got == want
    for c in caches[1:]:
        assert c.pos == caches[0].pos == 40 + steps
        assert torch.equal(c.k, caches[0].k) and torch.equal(c.v, caches[0].v)


def test_graph_loop_batched_with_budgets_matches_the_eager_loop(tiny_model, monkeypatch):
    from light_whisper_tpu_torch.models.qwen3_asr.model import _decode_greedy_batch

    cfg, params = tiny_model.config.decoder, tiny_model.decoder_params
    cache, firsts = _prompt_cache(tiny_model, seed=2, batch=7)
    caches = [_clone(cache), _clone(cache)]
    budgets = [3, 24, 0, 11, 1, 24, 17]

    def loop(c):
        return lambda: _decode_greedy_batch(cfg, params, firsts, c, -1, GRAPH_BUDGET, budgets=budgets)

    got, launches, spans = _run(loop(caches[0]), True, monkeypatch)
    eager, eager_launches, _ = _run(loop(caches[1]), False, monkeypatch)
    np.testing.assert_array_equal(got, eager)
    assert [int((row >= 0).sum()) for row in got] == [min(b, GRAPH_BUDGET) for b in budgets]
    steps = GRAPH_BUDGET - 1
    assert spans == {"model.decode.step": steps, "model.decode.capture": 1, "model.decode.replay": steps}
    assert launches == eager_launches and launches["decode_attention_batched"] == cfg.block_count * steps
    assert caches[0].pos_host == caches[1].pos_host == caches[0].pos.tolist() == caches[1].pos.tolist()
    assert torch.equal(caches[0].k, caches[1].k) and torch.equal(caches[0].v, caches[1].v)


def test_captures_beside_threads_that_launch(tiny_model, monkeypatch):
    """A capture completes while another thread launches kernels and
    allocates, on its own stream and on its default one, and two loops
    capture and replay at once on two threads: every loop gives the eager
    loop's ids."""
    import threading

    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    cfg, params = tiny_model.config.decoder, tiny_model.decoder_params
    cache, first = _prompt_cache(tiny_model, seed=3)
    want, _, _ = _run(lambda: dec.decode_greedy(cfg, params, first, _clone(cache), -1, GRAPH_BUDGET), False,
                      monkeypatch)
    stop = threading.Event()

    def busy(own_stream: bool):
        a = torch.randn(1024, 1024, device="cuda")
        stream = torch.cuda.Stream() if own_stream else torch.cuda.current_stream()
        with torch.cuda.stream(stream):
            while not stop.is_set():
                a = torch.tanh(a @ a)
                torch.empty(1 << 20, device="cuda")
        stream.synchronize()

    results, errors = [], []

    def loop():
        try:
            results.append(dec.decode_greedy(cfg, params, first, _clone(cache), -1, GRAPH_BUDGET))
        except BaseException as e:  # surfaced below
            errors.append(e)

    workers = [threading.Thread(target=busy, args=(own,)) for own in (True, False)]
    for w in workers:
        w.start()
    try:
        for _round in range(3):
            loops = [threading.Thread(target=loop) for _ in range(2)]
            for t in loops:
                t.start()
            for t in loops:
                t.join()
    finally:
        stop.set()
        for w in workers:
            w.join()
    assert not errors, errors
    assert results == [want] * 6


def test_short_loops_end_while_other_threads_capture(tiny_model, monkeypatch):
    """Loops of two steps on three threads at once, each capturing, replaying
    and releasing its graph and pool while the others capture: a release
    waits for a capture (freeing a pool syncs, which a capture forbids), and
    every loop gives the eager loop's ids."""
    import threading

    from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec

    cfg, params = tiny_model.config.decoder, tiny_model.decoder_params
    cache, first = _prompt_cache(tiny_model, seed=5)
    want, _, _ = _run(lambda: dec.decode_greedy(cfg, params, first, _clone(cache), -1, GRAPH_BUDGET, budget=3),
                      False, monkeypatch)
    spans0 = _span_counts()
    results, errors = [], []

    def loops():
        try:
            for _ in range(20):
                results.append(dec.decode_greedy(cfg, params, first, _clone(cache), -1, GRAPH_BUDGET, budget=3))
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=loops) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(want) == 3 and results == [want] * 60
    spans = _delta(spans0, _span_counts())
    assert spans == {"model.decode.step": 120, "model.decode.capture": 60, "model.decode.replay": 120}


def test_transcribe_paths_give_the_eager_tokens_and_release_their_graphs(tiny_model, monkeypatch):
    """``transcribe`` and ``transcribe_batch`` (B=7) serve the eager loops'
    tokens; a loop's graph and pool go when it ends, so the card's reserved
    memory does not grow loop after loop."""
    rng = np.random.default_rng(4)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in (1.0, 1.5, 2.0, 1.0, 3.0,
                                                                                        2.5, 1.0)]
    single, _, spans = _run(lambda: [tiny_model.transcribe(c).tokens for c in clips], True, monkeypatch)
    assert spans["model.decode.capture"] == len(clips)
    eager, _, _ = _run(lambda: [tiny_model.transcribe(c).tokens for c in clips], False, monkeypatch)
    assert single == eager
    batch, _, spans = _run(lambda: [r.tokens for r in tiny_model.transcribe_batch(clips)], True, monkeypatch)
    eager_batch, _, _ = _run(lambda: [r.tokens for r in tiny_model.transcribe_batch(clips)], False, monkeypatch)
    assert batch == eager_batch and spans["model.decode.capture"] == 1
    tiny_model.transcribe(clips[0])
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for _ in range(6):
        tiny_model.transcribe(clips[0])
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() - reserved < 8 << 20

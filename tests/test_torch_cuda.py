"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here launches a kernel, carries the ``cuda`` marker and skips
without a GPU. The file imports no JAX, so it also runs on a machine that has
only PyTorch: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py`` (the repository's conftest imports JAX).
Tolerances as in ``chip_smoke.py``: 1e-4 relative for the Q8 forms, one bf16
ulp for the residual epilogue, 5e-3 for attention, bitwise on integers.
"""

import numpy as np
import pytest
import torch

from light_whisper_tpu.formats.gguf import quantize_q8_0
from light_whisper_tpu_torch.ops import decode_attention as da
from light_whisper_tpu_torch.ops import q8_matmul as q8

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

"""Port decode attention against the Pallas kernel (interpret mode) and the
reference decoder's einsum attention.

G·T >= 8 reaches ``decode_attention_pallas_stacked`` in the reference; T=1
and T>64 take its einsum path (``decoder._attention``), which the port's
kernel (T=1) and plain path (T>64) are held against. Tolerance 5e-3 for the
bf16 rounding of the softmax weights.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec
from light_whisper_tpu.ops.decode_attention import decode_attention_pallas_stacked
from light_whisper_tpu_torch.ops import decode_attention as da

TOL = 5e-3


def _case(T, L=2, Hq=4, Hkv=2, C=256, hd=128, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((T, Hq, hd)) * 2.0).astype(np.float32)
    k = jnp.asarray(rng.standard_normal((L, Hkv, C, hd)).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((L, Hkv, C, hd)).astype(np.float32)).astype(jnp.bfloat16)
    kt = torch.from_numpy(np.array(k.astype(jnp.float32))).to(torch.bfloat16)
    vt = torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16)
    return q, k, v, kt, vt


@pytest.mark.parametrize("T,start", [(4, 0), (4, 100), (8, 37), (64, 150)])
def test_matches_pallas_stacked(T, start):
    q, k, v, kt, vt = _case(T, seed=T + start)
    pos = jnp.arange(T, dtype=jnp.int32) + start
    for layer in range(2):
        want = np.asarray(decode_attention_pallas_stacked(
            jnp.asarray(q), k, v, pos, jnp.int32(layer), interpret=True))
        got = da.decode_attention(torch.from_numpy(q), kt, vt, start, layer).numpy()
        assert got.shape == (T, 4, 128) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("T,start,C", [(1, 0, 256), (1, 255, 256), (1, 77, 256), (72, 10, 256)])
def test_matches_reference_einsum(T, start, C):
    """T=1 (the port's kernel, the reference's einsum) and T>64 (plain on both)."""
    q, k, v, kt, vt = _case(T, C=C, seed=start)
    pos = jnp.arange(T, dtype=jnp.int32) + start
    want = np.asarray(ref_dec._attention(jnp.asarray(q), k[1], v[1], pos, 2, jnp.bfloat16))
    if T <= da.MAX_ROWS:
        got = da.decode_attention(torch.from_numpy(q), kt, vt, start, 1)
    else:
        got = da.attention_plain(torch.from_numpy(q), kt[1], vt[1], start)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_precise_mode_attention_stays_f32():
    q, k, v, _, _ = _case(3, seed=4)
    kf = jnp.asarray(k).astype(jnp.float32)
    vf = jnp.asarray(v).astype(jnp.float32)
    pos = jnp.arange(3, dtype=jnp.int32) + 5
    want = np.asarray(ref_dec._attention(jnp.asarray(q), kf[0], vf[0], pos, 2, jnp.float32))
    got = da.attention_plain(torch.from_numpy(q), torch.from_numpy(np.array(kf[0])),
                             torch.from_numpy(np.array(vf[0])), 5, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_keys_past_each_row_are_ignored():
    """Garbage past a row's position (the padded prompt tail) changes nothing."""
    q, _, _, kt, vt = _case(4, seed=9)
    base = da.decode_attention(torch.from_numpy(q), kt, vt, 20, 0)
    kt2, vt2 = kt.clone(), vt.clone()
    kt2[0, :, 24:] = 1e4
    vt2[0, :, 24:] = -1e4
    torch.testing.assert_close(da.decode_attention(torch.from_numpy(q), kt2, vt2, 20, 0), base)


def test_refuses_other_devices():
    q = torch.zeros((1, 4, 128), device="meta")
    kc = torch.zeros((1, 2, 16, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention(q, kc, kc, 0, 0)


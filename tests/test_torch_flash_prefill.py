"""Prefill attention against a long cache: the port's online softmax against
the reference's Pallas flash kernel (interpret mode) and its chunked scan.

- ``flash_prefill_plain(block_c=512)`` is the TPU kernel's own arithmetic: it
  must match ``_flash_rows`` and ``flash_prefill_attention(interpret=True)``
  within 1e-5 absolute plus one bf16 ulp relative (``TOL``), on the shapes of
  ``tests/test_flash_prefill.py``;
- ``attention_chunked`` must match ``_attention_chunked`` within ``TOL``, with
  bf16 and with f32 operands;
- ``flash_prefill_split_plain`` (the CUDA kernel's schedule: row tiles of 128,
  the visible keys of a tile cut into S shares whose states merge in rank
  order) matches ``flash_prefill_plain`` and the Pallas kernel within 5e-3
  absolute, the card's tolerance (p is rounded to bf16 against each share's
  own running max), at S = 1, 2, 8, 16, with empty shares and share bounds
  that are not multiples of the key tile; ``prefill_splits`` reads the static
  shapes only, so ``forward`` and ``forward_prefill_batch`` at B=1 take the
  same schedule and agree;
- the router sends T > 64 bf16 rows at C >= 8192 to ``flash_prefill`` on the
  card and to ``attention_chunked`` on the CPU, and the wrapper refuses what
  the kernel does not take.

Inputs are made with numpy from a seed and are bf16-representable, so both
packages see the same operands; the reference gets f32 queries so that its
output stays f32 (it casts q to bf16 itself)."""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_whisper_tpu.models.qwen3_asr.decoder import _attention_chunked
from light_whisper_tpu.ops.flash_prefill import _flash_rows, flash_prefill_attention
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.ops import flash_prefill as fp

# 1e-5 absolute: every operand and rounding step is the same, f32 sums run in
# another order. Plus one bf16 ulp (2^-8) relative: q.k summed in another order
# can move a p that sits on a bf16 rounding boundary to the other side, which
# changes that term of p.v by one bf16 ulp (seen on 3 of 73,728 elements).
TOL = dict(rtol=2.0**-8, atol=1e-5)


def _inputs(T, n_heads, n_kv, capacity, start, seed=0, hd=128):
    rng = np.random.default_rng(seed)

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)

    q = bf16(rng.standard_normal((T, n_heads, hd)))
    k = bf16(rng.standard_normal((n_kv, capacity, hd)) * 0.2)
    v = bf16(rng.standard_normal((n_kv, capacity, hd)) * 0.2)
    return q, k, v


def _jnp(t, dtype=jnp.bfloat16):
    return jnp.asarray(t.float().numpy()).astype(dtype)


SHAPES = [
    pytest.param(128, 16, 8, 1024, 896, id="T128-G2-start896-C1024"),
    pytest.param(12, 4, 2, 512, 40, id="ragged-12rows"),
    pytest.param(96, 6, 2, 512, 200, id="ragged-96rows-G3"),
    pytest.param(512, 16, 8, 8192, 8192 - 512, id="T512-end-of-C8192"),
]


@pytest.mark.parametrize("T,n_heads,n_kv,capacity,start", SHAPES)
def test_plain_matches_the_pallas_kernel(T, n_heads, n_kv, capacity, start):
    q, k, v = _inputs(T, n_heads, n_kv, capacity, start)
    got = fp.flash_prefill_plain(q, k, v, start, block_c=512).numpy()
    q_pos = jnp.arange(start, start + T, dtype=jnp.int32)
    want = np.asarray(flash_prefill_attention(_jnp(q, jnp.float32), _jnp(k), _jnp(v), q_pos, interpret=True))
    assert want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("T,n_heads,n_kv,capacity,start", SHAPES[:3])
def test_plain_matches_flash_rows_with_padding_rows(T, n_heads, n_kv, capacity, start):
    """The kernel itself, padding rows (position -1) included: real rows
    agree, and rows that see no key come out exactly 0 in both."""
    q, k, v = _inputs(T, n_heads, n_kv, capacity, start, seed=1)
    G, hd = n_heads // n_kv, q.shape[-1]
    rows = G * T
    pad = -rows % 8
    q_rows = _jnp(q).reshape(T, n_kv, G, hd).transpose(1, 2, 0, 3).reshape(n_kv, rows, hd)
    q_rows = jnp.pad(q_rows, ((0, 0), (0, pad), (0, 0)))
    qpos = jnp.pad(jnp.tile(jnp.arange(start, start + T, dtype=jnp.int32), (G,)), (0, pad), constant_values=-1)
    want = np.asarray(_flash_rows(q_rows, _jnp(k), _jnp(v), qpos[None, :], rows + pad, 512, True))
    got = fp.flash_prefill_plain(q, k, v, start, block_c=512).numpy()  # [T, Hq, hd]
    got_rows = got.reshape(T, n_kv, G, hd).transpose(1, 2, 0, 3).reshape(n_kv, rows, hd)
    np.testing.assert_allclose(got_rows, want[:, :rows], **TOL)
    np.testing.assert_array_equal(want[:, rows:], 0.0)


def test_a_row_that_sees_no_key_is_exactly_zero():
    q, k, v = _inputs(4, 4, 2, 64, 0)
    k_empty = k[:, :0]  # no key at all: l == 0 for every row
    out = fp.flash_prefill_plain(q, k_empty, v[:, :0], 0)
    assert torch.equal(out, torch.zeros_like(out))


# (T, Hq, Hkv, C, start): one tile of 36 rows over 52 keys (at S = 16, shares of 4 keys and three
# empty ones), three tiles at G = 3, and a ragged last tile of 88 rows at G = 2
SPLIT_SHAPES = [
    pytest.param(12, 6, 2, 512, 40, id="one-tile-52keys-G3"),
    pytest.param(96, 6, 2, 512, 200, id="three-tiles-G3"),
    pytest.param(300, 16, 8, 1024, 700, id="ragged-last-tile-G2"),
]


@functools.lru_cache(maxsize=None)
def _pallas_reference(T, n_heads, n_kv, capacity, start):
    q, k, v = _inputs(T, n_heads, n_kv, capacity, start, seed=4)
    q_pos = jnp.arange(start, start + T, dtype=jnp.int32)
    return np.asarray(flash_prefill_attention(_jnp(q, jnp.float32), _jnp(k), _jnp(v), q_pos, interpret=True))


@pytest.mark.parametrize("splits", [1, 2, 8, 16])
@pytest.mark.parametrize("T,n_heads,n_kv,capacity,start", SPLIT_SHAPES)
def test_split_plain_matches_plain_and_the_pallas_kernel(T, n_heads, n_kv, capacity, start, splits):
    q, k, v = _inputs(T, n_heads, n_kv, capacity, start, seed=4)
    got = fp.flash_prefill_split_plain(q, k, v, start, splits)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), fp.flash_prefill_plain(q, k, v, start).numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(got.numpy(), _pallas_reference(T, n_heads, n_kv, capacity, start), rtol=0, atol=5e-3)


def test_split_plain_at_one_split_is_the_plain_version():
    """S = 1 walks each tile's keys in the plain version's key blocks: the
    same arithmetic, so the same result to f32 reordering of p·v's tiles."""
    q, k, v = _inputs(300, 16, 8, 1024, 700, seed=5)
    torch.testing.assert_close(fp.flash_prefill_split_plain(q, k, v, 700, 1), fp.flash_prefill_plain(q, k, v, 700),
                               rtol=0, atol=1e-6)


def test_an_empty_share_weighs_nothing():
    """Rows of one position over a single key: at S = 8 seven shares are
    empty (max -1e30, denominator 0) and the result is that key's value."""
    q, k, v = _inputs(1, 2, 1, 64, 0, seed=6)
    out = fp.flash_prefill_split_plain(q, k, v, 0, 8)
    torch.testing.assert_close(out[0], v[0, :1].float().expand(2, -1), rtol=0, atol=0)


@pytest.mark.parametrize(
    "T,n_heads,n_kv,capacity,want",
    [
        (3968, 16, 8, 8192, 1),  # the single-pass prompt: 496 row tiles fill the card
        (512, 16, 8, 32768, 2),  # 64 tiles: two shares each
        (128, 16, 8, 8192, 4),  # 16 tiles at the single-pass capacity: at most MAX_SPLITS
        (65, 16, 8, 8192, 4),
        (128, 16, 8, 1024, 2),  # every share keeps 512 slots of the capacity
        (2, 2, 1, 8192, 4),
    ],
)
def test_prefill_splits_reads_the_static_shapes_only(T, n_heads, n_kv, capacity, want):
    assert list(inspect.signature(fp.prefill_splits).parameters) == ["T", "n_heads", "n_kv", "capacity"]
    assert fp.prefill_splits(T, n_heads, n_kv, capacity) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("T,start,capacity", [(128, 3968, 8192), (200, 8192 - 200, 8192), (96, 0, 8192)])
def test_attention_chunked_matches_the_reference(dtype, T, start, capacity):
    n_heads, n_kv = 4, 2
    q, k, v = _inputs(T, n_heads, n_kv, capacity, start, seed=2)
    if dtype == torch.float32:  # precise mode: f32 operands that are not bf16 values
        rng = np.random.default_rng(3)
        q = q.float() + torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)) * 1e-3
        k, v = k.float(), v.float()
    got = dec.attention_chunked(q, k, v, start, dtype).numpy()
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q_pos = jnp.arange(start, start + T, dtype=jnp.int32)
    want = np.asarray(_attention_chunked(
        jnp.asarray(q.float().numpy()), jnp.asarray(k.float().numpy()).astype(jdtype),
        jnp.asarray(v.float().numpy()).astype(jdtype), q_pos, n_heads // n_kv, jdtype))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "dtype,T,capacity,device,route",
    [
        (torch.bfloat16, 65, 8192, "cuda", "flash_prefill"),
        (torch.bfloat16, 3968, 32768, "cuda", "flash_prefill"),
        (torch.bfloat16, 65, 8192, "cpu", "attention_chunked"),
        (torch.float32, 65, 8192, "cuda", "attention_chunked"),
        (torch.float32, 2, 8192, "cpu", "attention_chunked"),
        (torch.bfloat16, 64, 8192, "cuda", "decode_attention"),
        (torch.bfloat16, 1, 8192, "cuda", "decode_attention"),
        (torch.bfloat16, 192, 4096, "cuda", "attention_plain"),
        (torch.float32, 1, 8192, "cpu", "attention_plain"),
    ],
)
def test_router(dtype, T, capacity, device, route):
    assert dec._attention_route(dtype, T, capacity, device) == route


def test_cpu_prefill_takes_the_chunked_softmax(monkeypatch):
    """On the CPU the decoder's long-cache prefill runs ``attention_chunked``
    and never the kernel's wrapper."""
    calls = []
    monkeypatch.setattr(dec, "flash_prefill", lambda *a: calls.append("flash") or None)
    real = dec.attention_chunked
    monkeypatch.setattr(dec, "attention_chunked", lambda *a: calls.append("chunked") or real(*a))
    cfg = dec.DecoderConfig(embedding_length=64, block_count=1, head_count=4, head_count_kv=2,
                            key_length=128, feed_forward_length=128, vocab_size=256)
    cache = dec.init_cache(cfg, 8192)
    q, _, _ = _inputs(65, 4, 2, 8, 0)
    out = dec._attention(cfg, q, cache, 0, 100)
    assert calls == ["chunked"] and out.shape == (65, 4, 128)


@pytest.mark.parametrize(
    "change,match",
    [
        ("head_dim", "head dim"),
        ("f32_cache", "bf16"),
        ("strided_cache", "contiguous"),
        ("past_capacity", "exceed"),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(change, match):
    """The checks run before any build or launch (a ``meta`` tensor stands for
    the card's: nothing is computed)."""
    T, hd, C = 65, 128, 1024
    q = torch.empty((T, 4, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, C, hd), dtype=torch.bfloat16, device="meta")
    v = torch.empty_like(k)
    start = 0
    if change == "head_dim":
        q, k = q[..., :64], torch.empty((2, C, 64), dtype=torch.bfloat16, device="meta")
        v = torch.empty_like(k)
    elif change == "f32_cache":
        k, v = k.float(), v.float()
    elif change == "strided_cache":
        k = torch.empty((C, 2, hd), dtype=torch.bfloat16, device="meta").transpose(0, 1)
        v = torch.empty_like(k)
    elif change == "past_capacity":
        start = C - T + 1
    with pytest.raises(ValueError, match=match):
        fp.flash_prefill(q, k, v, start)


# -- the decoder at capacity 8192: both packages take the chunked route -------------

START, NEW = 4000, 128


def _long_caches(batched: bool):
    """A cache of 8192 slots filled to ``START`` from a seed, junk past it."""
    from test_torch_batch_decoder import CFG, _to_torch
    from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec

    rng = np.random.default_rng(11)
    shape = (CFG.block_count, CFG.head_count_kv, 8192, CFG.key_length)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    k[:, :, START:], v[:, :, START:] = 1e4, -1e4
    kj, vj = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    if batched:
        jcache = ref_dec.KVCache(k=kj[None], v=vj[None], pos=jnp.asarray([START], jnp.int32))
        tcache = dec.init_cache_batch(CFG, 1, 8192)
        tcache.k.copy_(_to_torch(kj)[None])
        tcache.v.copy_(_to_torch(vj)[None])
        tcache.set_positions([START])
    else:
        jcache = ref_dec.KVCache(k=kj, v=vj, pos=jnp.int32(START))
        tcache = dec.init_cache(CFG, 8192)
        tcache.k.copy_(_to_torch(kj))
        tcache.v.copy_(_to_torch(vj))
        tcache.pos = START
    return jcache, tcache


@pytest.mark.parametrize("batched", [False, True], ids=["forward", "forward_prefill_batch-B1"])
def test_decoder_at_capacity_8192_matches_the_reference(monkeypatch, batched):
    """128 new rows at position 4000 of an 8192-slot cache through two Q8_0
    layers: hidden states within 3e-2 of max|h| (bf16 activations summed in
    another order, as in test_torch_batch_decoder.py), and both packages'
    attention took the online-softmax route (the reference's
    ``_attention_chunked``, the port's ``attention_chunked``)."""
    from test_torch_batch_decoder import CFG, _assert_hidden_close, _embeds, _params
    from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec

    routes = []
    real_ref, real_port = ref_dec._attention_chunked, dec.attention_chunked
    monkeypatch.setattr(ref_dec, "_attention_chunked", lambda *a: routes.append("ref") or real_ref(*a))
    monkeypatch.setattr(dec, "attention_chunked", lambda *a: routes.append("port") or real_port(*a))
    jparams, tparams = _params(True, seed=12)
    jcache, tcache = _long_caches(batched)
    if batched:
        ej, et = _embeds((1, NEW, CFG.embedding_length), seed=13)
        want, _ = ref_dec.forward_prefill_batch(CFG, jparams, ej, jcache)
        got = dec.forward_prefill_batch(CFG, tparams, et, tcache)
        assert tcache.pos_host == [START + NEW]
    else:
        ej, et = _embeds((NEW, CFG.embedding_length), seed=13)
        want, _ = ref_dec.forward(CFG, jparams, ej, jcache)
        got = dec.forward(CFG, tparams, et, tcache)
        assert tcache.pos == START + NEW
    _assert_hidden_close(got, want)
    assert routes.count("port") == CFG.block_count and "ref" in routes


def test_forward_and_the_batched_prefill_take_one_split_schedule(monkeypatch):
    """With the card's route and the kernel's schedule in torch standing in
    for the kernel, ``forward`` and ``forward_prefill_batch`` at B=1 call it
    with the same shapes, so the same split count whatever the start, and
    their hidden states agree within the batched decoder tests' tolerance."""
    from test_torch_batch_decoder import CFG, REL_TOL, _embeds, _params

    calls = []

    def kernel_schedule(q, k_layer, v_layer, start):
        splits = fp.prefill_splits(q.shape[0], q.shape[1], k_layer.shape[0], k_layer.shape[1])
        calls.append((tuple(q.shape), tuple(k_layer.shape), start, splits))
        return fp.flash_prefill_split_plain(q, k_layer, v_layer, start, splits)

    real_route = dec._attention_route
    monkeypatch.setattr(dec, "_attention_route", lambda dtype, T, capacity, device: real_route(dtype, T, capacity, "cuda"))
    monkeypatch.setattr(dec, "flash_prefill", kernel_schedule)
    _jparams, tparams = _params(True, seed=12)
    outs = {}
    for batched in (False, True):
        _jcache, tcache = _long_caches(batched)
        if batched:
            _ej, et = _embeds((1, NEW, CFG.embedding_length), seed=13)
            outs[batched] = dec.forward_prefill_batch(CFG, tparams, et, tcache)[0]
        else:
            _ej, et = _embeds((NEW, CFG.embedding_length), seed=13)
            outs[batched] = dec.forward(CFG, tparams, et, tcache)
    assert len(calls) == 2 * CFG.block_count and len(set(calls)) == 1, calls
    assert calls[0][2:] == (START, fp.prefill_splits(NEW, CFG.head_count, CFG.head_count_kv, 8192))
    # the two paths' bf16 activations may round one ulp apart (another matmul shape), as in
    # test_torch_batch_decoder.py
    err = float((outs[False].float() - outs[True].float()).abs().max())
    assert err <= REL_TOL * max(1.0, float(outs[False].float().abs().max())), err

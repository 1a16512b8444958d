"""The port's fused decode FFN against the JAX package's, kernel and slice.

On the CPU the port's wrappers take their plain versions (at the CUDA kernel's
tile of 32 columns); the JAX side runs the Pallas kernels with
``interpret=True``, as tests/test_q8_matmul.py does. Tolerances:

- ``fused_ffn_step``: 1e-3 of max|ref| against the reference's own XLA
  statement of the kernel (tests/test_q8_matmul.py::
  test_fused_ffn_step_matches_unfused): the rms-norm's rsqrt and the bf16
  rounding of ``inner`` may move one bf16 ulp; the sums run in another order.
  Against the Pallas kernel in interpret mode, 2e-2 of max|ref|, the
  tolerance the reference holds that kernel to: at one row, XLA on the CPU
  keeps the kernel's dequantised weights ``q·s`` in f32 (excess precision),
  where the TPU, the port and the XLA statement round them to bf16. So the
  tight check, 1e-5 of max|ref|, holds the port's plain version against the
  interpret-mode kernel as it is at T > 1, and the plain version with
  unrounded weights against it at T = 1: that pins the T = 1 difference to
  the weight rounding alone.
- ``fused_gateup_silu``: one bf16 ulp of max(|got|, |want|).
- The slice (a prefill, then 8 single-token decode steps with
  ``LWT_FUSED_FFN=1``, against JAX ``forward`` on the same program path):
  hidden states within 2e-2 of max|h| and the written K/V rows within 0.05 +
  2e-2 relative (bf16 activations through two layers, as the batched decoder
  tests hold them); the port's greedy token equals the JAX token at every
  step, or flips only where the JAX top-2 gap is inside the 1e-3 tie band
  (each flip is printed).
- The gate: unset (or ``""`` / ``"0"``), ``forward`` never reaches the fused
  kernel and its output is bitwise the unfused half's; set, the batched
  forwards still never reach it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import light_whisper_tpu.ops.fused_ffn as ref_ffn
import light_whisper_tpu.ops.q8_matmul as ref_q8
from light_whisper_tpu.formats.gguf import quantize_q8_0
from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec
from light_whisper_tpu.models.qwen3_asr.config import DecoderConfig
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr.loader import to_bf16
from light_whisper_tpu_torch.models.qwen3_asr.params import params_from_numpy
from light_whisper_tpu_torch.ops import fused_ffn as ffn
from light_whisper_tpu_torch.ops import q8_matmul as q8

TIE_BAND = 1e-3
L, D, F = 2, 512, 1024
REFERENCE_BLOCK_F = 512  # the TPU kernel's default block_f


def _q8_stack(rng, out_f, in_f, scale=0.05):
    qs, ss = zip(*(quantize_q8_0((rng.standard_normal((out_f, in_f)) * scale).astype(np.float32))
                   for _ in range(L)))
    return np.stack(qs), np.stack(ss)  # int8 [L, out, in], f16 [L, out, in/32]


def _ffn_weights(seed):
    rng = np.random.default_rng(seed)
    gq, gs = _q8_stack(rng, 2 * F, D)
    dq, ds = _q8_stack(rng, D, F)
    norm_w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    return rng, gq, gs, dq, ds, norm_w


def _s_t(s):
    return jnp.asarray(s).astype(jnp.bfloat16).transpose(0, 2, 1)


def _bf16_rows(rng, T, width):
    x = jnp.asarray(rng.standard_normal((T, width)).astype(np.float32)).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)


# -- kernels ------------------------------------------------------------------------


def _xla_statement(xj, norm_w, gq, gs, dq, ds, layer):
    """The reference's XLA statement of its fused FFN kernel (bf16 weights)."""
    from light_whisper_tpu.ops.linear import q8_matmul_xla

    xf = xj.astype(jnp.float32)
    h = (xf * jax.lax.rsqrt(jnp.mean(xf * xf, -1, keepdims=True) + 1e-6) * norm_w).astype(jnp.bfloat16)
    gate, up = jnp.split(q8_matmul_xla(h, jnp.asarray(gq[layer]), jnp.asarray(gs[layer])), 2, -1)
    inner = (jax.nn.silu(gate) * up).astype(jnp.bfloat16)
    return np.asarray(xf + q8_matmul_xla(inner, jnp.asarray(dq[layer]), jnp.asarray(ds[layer])))


def _deq_f32(q, s):
    return q.float() * s.float().repeat_interleave(32, dim=-1)


def _gateup_with_f32_weights(h, gq, gs, layer):
    """:func:`ffn.fused_gateup_silu_plain` with ``q·s`` left in f32, as XLA on
    the CPU runs the interpret-mode kernel at one row."""
    gate, up = torch.chunk(h.float() @ _deq_f32(gq[layer], gs[layer]).t(), 2, dim=-1)
    return (gate * torch.sigmoid(gate) * up).to(torch.bfloat16)


def _plain_with_f32_weights(xt, norm_w, gq, gs, dq, ds, layer, block_f=REFERENCE_BLOCK_F):
    """The plain version with ``q·s`` left in f32 (see above)."""
    inner = _gateup_with_f32_weights(dec.rms_norm(xt, norm_w, 1e-6), gq, gs, layer).float()
    w_down = _deq_f32(dq[layer], ds[layer])
    out = xt.float()
    for f0 in range(0, F, block_f):
        out = out + inner[:, f0 : f0 + block_f] @ w_down[:, f0 : f0 + block_f].t()
    return out.numpy()


@pytest.mark.parametrize("block_f", [ffn.KERNEL_BLOCK_F, REFERENCE_BLOCK_F], ids=["kernel-tile", "tpu-tile"])
@pytest.mark.parametrize("T", [1, 4, 8])
def test_fused_ffn_step_matches_jax(T, block_f):
    rng, gq, gs, dq, ds, norm_w = _ffn_weights(seed=T)
    xj, xt = _bf16_rows(rng, T, D)
    weights = (torch.from_numpy(gq), to_bf16(gs), torch.from_numpy(dq), to_bf16(ds))
    for layer in range(L):
        kernel = np.asarray(ref_ffn.fused_ffn_step(xj, jnp.asarray(norm_w), jnp.asarray(gq), _s_t(gs),
                                                   jnp.asarray(dq), _s_t(ds), jnp.int32(layer), interpret=True))
        statement = _xla_statement(xj, jnp.asarray(norm_w), gq, jnp.asarray(gs).astype(jnp.bfloat16), dq,
                                   jnp.asarray(ds).astype(jnp.bfloat16), layer)
        args = (xt, torch.from_numpy(norm_w), *weights, layer)
        if block_f == ffn.KERNEL_BLOCK_F:
            got = ffn.fused_ffn_step(*args).numpy()  # the CPU route of the wrapper
        else:
            got = ffn.fused_ffn_step_plain(*args, block_f=block_f).numpy()
        assert got.shape == (T, D) and got.dtype == np.float32
        scale = max(1.0, np.abs(statement).max())
        assert np.abs(got - statement).max() <= 1e-3 * scale, (layer, np.abs(got - statement).max())
        assert np.abs(got - kernel).max() <= 2e-2 * scale, (layer, np.abs(got - kernel).max())
        # with the weights rounded as XLA on the CPU rounds them, the match is tight
        tight = _plain_with_f32_weights(*args) if T == 1 else got
        assert np.abs(tight - kernel).max() <= 1e-5 * scale, (layer, np.abs(tight - kernel).max())


def _within_one_ulp(got, want):
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp * 1.0001), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("T", [1, 8])
def test_fused_gateup_silu_matches_jax(T):
    """One bf16 ulp of the interpret-mode kernel; at T = 1 with the weights
    left in f32 as XLA leaves them there, and the port's bf16 weights then
    within the reference's own 2e-2 (tests/test_q8_matmul.py)."""
    rng, gq, gs, _dq, _ds, _n = _ffn_weights(seed=10 + T)
    hj, ht = _bf16_rows(rng, T, D)
    for layer in range(L):
        want = np.asarray(ref_ffn.fused_gateup_silu(hj, jnp.asarray(gq), _s_t(gs), jnp.int32(layer),
                                                    interpret=True).astype(jnp.float32))
        got = ffn.fused_gateup_silu(ht, torch.from_numpy(gq), to_bf16(gs), layer)
        assert got.dtype == torch.bfloat16 and got.shape == (T, F)
        got = got.float().numpy()
        if T == 1:
            _within_one_ulp(_gateup_with_f32_weights(ht, torch.from_numpy(gq), to_bf16(gs), layer).float().numpy(),
                            want)
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        else:
            _within_one_ulp(got, want)


def test_plain_sums_the_tiles_in_order_from_the_residual():
    """The plain version's tile order is the reference's: with one tile it is
    ``x + inner·W_down^T`` at once, and every tile width agrees within f32
    reordering."""
    _rng, gq, gs, dq, ds, norm_w = _ffn_weights(seed=3)
    x = torch.randn(3, D).to(torch.bfloat16)
    args = (x, torch.from_numpy(norm_w), torch.from_numpy(gq), to_bf16(gs), torch.from_numpy(dq), to_bf16(ds), 1)
    whole = ffn.fused_ffn_step_plain(*args, block_f=F)
    h = dec.rms_norm(x, torch.from_numpy(norm_w), 1e-6)
    inner = ffn.fused_gateup_silu_plain(h, torch.from_numpy(gq), to_bf16(gs), 1).float()
    w_down = ffn.dequantize(torch.from_numpy(dq)[1], to_bf16(ds)[1]).float()
    assert torch.equal(whole, x.float() + inner @ w_down.t())
    for block_f in (32, 256):
        torch.testing.assert_close(ffn.fused_ffn_step_plain(*args, block_f=block_f), whole, rtol=1e-5, atol=1e-5)


def test_wrappers_take_decode_rows_only_and_refuse_other_devices():
    q = torch.zeros((1, 64, 32), dtype=torch.int8)
    s = torch.zeros((1, 64, 1), dtype=torch.bfloat16)
    dq = torch.zeros((1, 32, 32), dtype=torch.int8)
    ds = torch.zeros((1, 32, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T<=8"):
        ffn.fused_ffn_step(torch.zeros((9, 32)), torch.ones(32), q, s, dq, ds, 0)
    with pytest.raises(ValueError, match="T<=8"):
        ffn.fused_gateup_silu(torch.zeros((9, 32)), q, s, 0)
    meta = torch.zeros((1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ffn.fused_ffn_step(meta, torch.ones(32), q, s, dq, ds, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        ffn.fused_gateup_silu(meta, q, s, 0)


def test_cpu_path_does_not_count_launches():
    _rng, gq, gs, dq, ds, norm_w = _ffn_weights(seed=4)
    before = dict(ffn.LAUNCHES)
    x = torch.randn(1, D).to(torch.bfloat16)
    ffn.fused_ffn_step(x, torch.from_numpy(norm_w), torch.from_numpy(gq), to_bf16(gs), torch.from_numpy(dq),
                       to_bf16(ds), 0)
    ffn.fused_gateup_silu(x, torch.from_numpy(gq), to_bf16(gs), 0)
    assert ffn.LAUNCHES == before


# -- the slice: prefill + 8 decode steps through the route ------------------------------

CFG = DecoderConfig(block_count=L, embedding_length=D, feed_forward_length=F, head_count=4, head_count_kv=2,
                    key_length=128, rms_epsilon=1e-6, rope_freq_base=1e6, vocab_size=128)
PROMPT_ROWS = 12
DECODE_STEPS = 8


def _decoder_params(seed=11):
    """(JAX tree with the TPU's pre-transposed scales, port tree) of one tiny
    stacked Q8 decoder."""
    rng = np.random.default_rng(seed)
    hd = CFG.key_length

    def q8lin(in_f, out_f):
        q, s = _q8_stack(rng, out_f, in_f, scale=1.0 / np.sqrt(in_f))
        return {"q": jnp.asarray(q), "s": jnp.asarray(s).astype(jnp.bfloat16)}

    def norm(n):
        return jnp.asarray((1.0 + 0.1 * rng.standard_normal((L, n))).astype(np.float32))

    layers = {"attn_norm": norm(D), "qkv": q8lin(D, (CFG.head_count + 2 * CFG.head_count_kv) * hd),
              "o": q8lin(CFG.head_count * hd, D), "q_norm": norm(hd), "k_norm": norm(hd), "ffn_norm": norm(D),
              "gateup": q8lin(D, 2 * F), "down": q8lin(F, D)}
    params = {"embed": {"w": jnp.asarray(rng.standard_normal((CFG.vocab_size, D)).astype(np.float32) * 0.5)},
              "layers": layers, "final_norm": jnp.asarray((1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32))}
    prepared = ref_dec.prepare_stacked_scales(params)
    assert "s_t" in prepared["layers"]["gateup"]
    _enc, tparams = params_from_numpy({}, jax.tree.map(np.asarray, prepared), device="cpu")
    embeds = jnp.asarray(rng.standard_normal((PROMPT_ROWS, D)).astype(np.float32)).astype(jnp.bfloat16)
    return prepared, tparams, embeds


@pytest.fixture
def jax_fused_path(monkeypatch):
    """The JAX package's forward on its layer-indexed fused path with the
    fused FFN on, every Pallas kernel in interpret mode (as
    tests/test_q8_matmul.py::test_decoder_fused_ffn_path_matches sets it up)."""
    monkeypatch.setattr(ref_dec, "_use_stacked_kernel", lambda layers: "s_t" in layers.get("qkv", {}))
    monkeypatch.setenv("LWT_FUSED_DECODE", "1")
    monkeypatch.setenv("LWT_FUSED_FFN", "1")
    monkeypatch.setattr(ref_q8, "q8_matmul_pallas_stacked",
                        functools.partial(ref_q8.q8_matmul_pallas_stacked, interpret=True))
    monkeypatch.setattr(ref_q8, "q8_matmul_pallas_stacked_fused",
                        functools.partial(ref_q8.q8_matmul_pallas_stacked_fused, interpret=True))
    monkeypatch.setattr(ref_ffn, "fused_ffn_step", functools.partial(ref_ffn.fused_ffn_step, interpret=True))
    jax.clear_caches()  # the gates are read at trace time
    yield
    jax.clear_caches()


def _count_fused_calls(monkeypatch):
    calls = []
    real = dec.fused_ffn_step
    monkeypatch.setattr(dec, "fused_ffn_step", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    return calls


def _hidden_close(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * max(1.0, np.abs(want).max()), err


def test_slice_prefill_and_decode_through_the_fused_ffn_matches_jax(jax_fused_path, monkeypatch):
    prepared, tparams, embeds = _decoder_params()
    calls = _count_fused_calls(monkeypatch)
    jcache = ref_dec.init_cache(CFG, 64)
    tcache = dec.init_cache(CFG, 64)
    jh, jcache = ref_dec.forward(CFG, prepared, embeds, jcache)
    th = dec.forward(CFG, tparams, torch.from_numpy(np.asarray(embeds.astype(jnp.float32))).to(torch.bfloat16),
                     tcache)
    _hidden_close(th, jh)
    assert calls == []  # the prompt's 12 rows take the unfused half, as in the reference
    flips = []
    for step in range(DECODE_STEPS):
        jlogits = np.asarray(ref_dec.logits_for(CFG, prepared, jh[-1:]))[-1]
        tlogits = dec.logits_for(CFG, tparams, th[-1:])[-1].numpy()
        token = int(np.argmax(jlogits))
        if int(np.argmax(tlogits)) != token:
            top2 = np.sort(jlogits)[-2:]
            flips.append((step, float(top2[1] - top2[0])))
        # both continue from the JAX token, so a tie cannot fork the inputs
        jh, jcache = ref_dec.forward(CFG, prepared, ref_dec.embed_tokens(prepared, jnp.asarray([token])), jcache)
        th = dec.forward(CFG, tparams, dec.embed_tokens(tparams, torch.tensor([token])), tcache)
        _hidden_close(th, jh)
    print(f"greedy flips (step, JAX top-2 gap): {flips}")
    assert all(gap <= TIE_BAND for _s, gap in flips), flips
    assert calls == [1] * (CFG.block_count * DECODE_STEPS)
    assert tcache.pos == int(jcache.pos) == PROMPT_ROWS + DECODE_STEPS
    n = tcache.pos
    for name in ("k", "v"):
        want = torch.from_numpy(np.asarray(getattr(jcache, name)[:, :, :n].astype(jnp.float32)))
        torch.testing.assert_close(getattr(tcache, name)[:, :, :n].float(), want, atol=0.05, rtol=0.02)


def _parent_ffn_half(cfg, layers, idx, x):
    """The FFN half as the decoder computed it before the route existed: the
    stacked-fused Q8 form with the norm prologue, silu·mul, and the
    stacked-fused form with the residual epilogue."""
    gu, dn = layers["gateup"], layers["down"]
    gateup = q8.q8_matmul_stacked_fused(x, gu["q"], gu["s"], idx, norm_w=layers["ffn_norm"][idx],
                                        eps=cfg.rms_epsilon)
    gate, up = torch.chunk(gateup, 2, dim=-1)
    inner = (torch.nn.functional.silu(gate) * up).to(x.dtype)
    return q8.q8_matmul_stacked_fused(inner, dn["q"], dn["s"], idx, residual=x).to(x.dtype)


@pytest.mark.parametrize("value", [None, "", "0"], ids=["unset", "empty", "zero"])
def test_gate_off_leaves_forward_bitwise_unfused(monkeypatch, value):
    """Gate off: a prefill and a decode step never reach the fused kernel and
    are bitwise the forward whose FFN half is the parent's statement."""
    if value is None:
        monkeypatch.delenv("LWT_FUSED_FFN", raising=False)
    else:
        monkeypatch.setenv("LWT_FUSED_FFN", value)
    assert dec._use_fused_ffn() is False is ref_dec._use_fused_ffn()
    _prepared, tparams, embeds = _decoder_params(seed=5)
    calls = _count_fused_calls(monkeypatch)
    cache = dec.init_cache(CFG, 32)
    x = torch.from_numpy(np.asarray(embeds[:3].astype(jnp.float32))).to(torch.bfloat16)
    got = [dec.forward(CFG, tparams, x, cache), dec.forward(CFG, tparams, x[:1], cache)]  # prefill, decode step
    assert calls == []
    # the route on, with the parent's statement in the fused kernel's place
    monkeypatch.setenv("LWT_FUSED_FFN", "1")
    monkeypatch.setattr(dec, "_fused_ffn_half", _parent_ffn_half)
    cache2 = dec.init_cache(CFG, 32)
    want = [dec.forward(CFG, tparams, x, cache2), dec.forward(CFG, tparams, x[:1], cache2)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(cache.k, cache2.k) and torch.equal(cache.v, cache2.v)


@pytest.mark.parametrize("value", ["1", "yes"])
def test_gate_on_routes_single_stream_decode_only(monkeypatch, value):
    monkeypatch.setenv("LWT_FUSED_FFN", value)
    assert dec._use_fused_ffn() is True is ref_dec._use_fused_ffn()
    _prepared, tparams, embeds = _decoder_params(seed=6)
    calls = _count_fused_calls(monkeypatch)
    x = torch.from_numpy(np.asarray(embeds.astype(jnp.float32))).to(torch.bfloat16)
    # batched decode (B = 3 rows) and batched prefill keep the unfused half
    bcache = dec.init_cache_batch(CFG, 3, 32)
    bcache.set_positions([2, 5, 0])
    dec.forward_decode_batch(CFG, tparams, x[:3], bcache)
    dec.forward_prefill_batch(CFG, tparams, x[:6].reshape(3, 2, D), bcache)
    assert calls == []
    # single stream: 8 rows take it, 9 do not
    dec.forward(CFG, tparams, x[:8], dec.init_cache(CFG, 32))
    assert calls == [8] * CFG.block_count
    dec.forward(CFG, tparams, x[:9], dec.init_cache(CFG, 32))
    assert calls == [8] * CFG.block_count


def test_gate_on_skips_dense_layers(monkeypatch):
    """The fused kernel reads Q8 weights; dense layers keep the unfused half."""
    monkeypatch.setenv("LWT_FUSED_FFN", "1")
    _prepared, tparams, embeds = _decoder_params(seed=7)
    layers = dict(tparams["layers"])
    for name in ("qkv", "o", "gateup", "down"):
        p = layers[name]
        layers[name] = {"w": ffn.dequantize(p["q"], p["s"]).transpose(1, 2).contiguous()}
    calls = _count_fused_calls(monkeypatch)
    x = torch.from_numpy(np.asarray(embeds[:1].astype(jnp.float32))).to(torch.bfloat16)
    dec.forward(CFG, dict(tparams, layers=layers), x, dec.init_cache(CFG, 16))
    assert calls == []


def test_barrier_count_is_zeroed_in_stream_order_before_it_could_wrap(monkeypatch):
    """The kernel's grid-barrier count grows by the grid every launch; the
    wrapper zeroes it every ``BARRIER_RESET`` launches of a (device, stream)
    and leaves it alone in between."""
    monkeypatch.setattr(ffn, "BARRIER_RESET", 3)
    monkeypatch.setattr(ffn, "_BARRIERS", {})
    monkeypatch.setattr(ffn, "_BARRIER_USES", {})
    dev = torch.device("cpu")
    seen = []
    for _launch in range(7):
        words = ffn._barrier(dev, 0)
        seen.append(int(words[0]))
        words[0] += 132  # what one launch of the kernel adds
    assert seen == [0, 132, 264, 0, 132, 264, 0]
    assert ffn._barrier(dev, 1) is not words  # another stream has its own count

"""The port's batched decoder against the JAX package's, layer for layer.

``forward_decode_batch`` (one token per stream, streams on the matmul row
axis) and ``forward_prefill_batch`` (T tokens per stream, rows [B·T, D]) run
the same numpy-made weights, dense and Q8_0, on streams at different cache
positions whose caches hold large junk past each position. Hidden states
agree within 3e-2 of max|h| (bf16 activations through two layers, summed in
another order), the written K/V rows within one bf16 rounding, and every
slot the step must not touch stays bitwise as it was.

``_decode_greedy_batch`` runs with the forward stubbed by a step-indexed
emission schedule (random tiny models rarely emit EOS) against the
reference's loop with the same schedule: staggered EOS, a stream whose first
token is EOS, per-stream budgets and the shared ``max_new_tokens`` cut.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_whisper_tpu.formats.gguf import quantize_q8_0
from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec
from light_whisper_tpu.models.qwen3_asr import model as ref_model
from light_whisper_tpu.models.qwen3_asr.config import DecoderConfig
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr import model as port_model
from light_whisper_tpu_torch.ops import decode_attention as da

CFG = DecoderConfig(block_count=2, embedding_length=256, feed_forward_length=512, head_count=4,
                    head_count_kv=2, key_length=128, rms_epsilon=1e-6, rope_freq_base=1e6, vocab_size=128)
JUNK = 1e4
REL_TOL = 3e-2


def _to_torch(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _params(quantized: bool, seed: int):
    """(jax tree, torch tree) of a 2-layer decoder holding the same numbers."""
    rng = np.random.default_rng(seed)
    D, F = CFG.embedding_length, CFG.feed_forward_length
    hd = CFG.key_length
    qdim, kvdim = CFG.head_count * hd, CFG.head_count_kv * hd

    def linear(in_f, out_f):
        w = (rng.standard_normal((CFG.block_count, out_f, in_f)) / np.sqrt(in_f)).astype(np.float32)
        if quantized:
            q, s = zip(*(quantize_q8_0(wl) for wl in w))
            return {"q": jnp.asarray(np.stack(q)), "s": jnp.asarray(np.stack(s)).astype(jnp.bfloat16)}
        return {"w": jnp.asarray(w.transpose(0, 2, 1)).astype(jnp.bfloat16)}

    def norm(n):
        return jnp.asarray((1.0 + 0.1 * rng.standard_normal((CFG.block_count, n))).astype(np.float32))

    layers = {"attn_norm": norm(D), "qkv": linear(D, qdim + 2 * kvdim), "o": linear(qdim, D),
              "q_norm": norm(hd), "k_norm": norm(hd), "ffn_norm": norm(D),
              "gateup": linear(D, 2 * F), "down": linear(F, D)}
    jparams = {"embed": {"w": jnp.asarray(rng.standard_normal((CFG.vocab_size, D)).astype(np.float32) * 0.02)},
               "layers": layers,
               "final_norm": jnp.asarray((1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32))}
    return jparams, jax.tree.map(_to_torch, jparams)


def _caches(positions, capacity, seed):
    """Per-stream caches [B, L, Hkv, C, hd] (jax, torch) with junk past each position."""
    rng = np.random.default_rng(seed)
    shape = (len(positions), CFG.block_count, CFG.head_count_kv, capacity, CFG.key_length)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    for b, p in enumerate(positions):
        k[b, :, :, p:] = JUNK
        v[b, :, :, p:] = -JUNK
    kj, vj = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    jcache = ref_dec.KVCache(k=kj, v=vj, pos=jnp.asarray(positions, jnp.int32))
    tcache = dec.init_cache_batch(CFG, len(positions), capacity)
    tcache.k.copy_(_to_torch(kj))
    tcache.v.copy_(_to_torch(vj))
    tcache.set_positions(positions)
    return jcache, tcache


def _embeds(shape, seed):
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)
    return x, _to_torch(x)


def _assert_hidden_close(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL_TOL * max(1.0, np.abs(want).max()), err


def _assert_cache_written(tcache, jcache_out, positions, T, before):
    """New rows [pos, pos + T) agree with the reference; every other slot is
    bitwise what it was."""
    for name in ("k", "v"):
        got = getattr(tcache, name)
        want = _to_torch(getattr(jcache_out, name))
        untouched = torch.ones(got.shape[:1] + got.shape[3:4], dtype=torch.bool)
        for b, p in enumerate(positions):
            new = got[b, :, :, p : p + T].float()
            torch.testing.assert_close(new, want[b, :, :, p : p + T].float(), atol=0.05, rtol=0.02)
            untouched[b, p : p + T] = False
        mask = untouched[:, None, None, :, None].expand_as(got)
        assert torch.equal(got[mask], before[name][mask])


@pytest.mark.parametrize("quantized", [True, False], ids=["q8_0", "dense"])
def test_forward_decode_batch_matches_jax(quantized):
    positions = [3, 17, 0, 40]
    jparams, tparams = _params(quantized, seed=1)
    jcache, tcache = _caches(positions, 64, seed=2)
    before = {"k": tcache.k.clone(), "v": tcache.v.clone()}
    xj, xt = _embeds((len(positions), CFG.embedding_length), seed=3)
    want, jout = ref_dec.forward_decode_batch(CFG, jparams, xj, jcache)
    got = dec.forward_decode_batch(CFG, tparams, xt, tcache)
    _assert_hidden_close(got, want)
    _assert_cache_written(tcache, jout, positions, 1, before)
    assert tcache.pos_host == [p + 1 for p in positions] == tcache.pos.tolist()
    assert tcache.pos.dtype == torch.int32


@pytest.mark.parametrize("quantized", [True, False], ids=["q8_0", "dense"])
@pytest.mark.parametrize("T", [5, 70])
def test_forward_prefill_batch_matches_jax(quantized, T):
    """T=5 reaches the unstacked attention (its plain version here), T=70 the
    plain masked softmax, as the reference's ``_attention`` routes them."""
    positions = [0, 9, 30]
    jparams, tparams = _params(quantized, seed=4)
    jcache, tcache = _caches(positions, 128, seed=5)
    before = {"k": tcache.k.clone(), "v": tcache.v.clone()}
    ej, et = _embeds((len(positions), T, CFG.embedding_length), seed=6)
    want, jout = ref_dec.forward_prefill_batch(CFG, jparams, ej, jcache)
    got = dec.forward_prefill_batch(CFG, tparams, et, tcache)
    _assert_hidden_close(got, want)
    _assert_cache_written(tcache, jout, positions, T, before)
    assert tcache.pos_host == [p + T for p in positions]


def test_prefill_batch_refuses_to_overrun_the_cache():
    _, tparams = _params(True, seed=0)
    _, tcache = _caches([0, 60], 64, seed=0)
    with pytest.raises(ValueError, match="exceed"):
        dec.forward_prefill_batch(CFG, tparams, torch.zeros(2, 5, CFG.embedding_length, dtype=torch.bfloat16),
                                  tcache)


def test_streams_are_isolated():
    """A stream's input or live cache moves that stream's output only."""
    positions = [4, 12, 7]
    _, tparams = _params(True, seed=7)
    _, base_cache = _caches(positions, 32, seed=8)
    _, x = _embeds((3, CFG.embedding_length), seed=9)

    def run(x, mutate=None):
        cache = dec.init_cache_batch(CFG, 3, 32)
        cache.k.copy_(base_cache.k)
        cache.v.copy_(base_cache.v)
        cache.set_positions(positions)
        if mutate:
            mutate(cache)
        return dec.forward_decode_batch(CFG, tparams, x, cache)

    base = run(x)
    x2 = x.clone()
    x2[1] = x2[1] * -2 + 0.5
    moved = run(x2)
    assert torch.equal(moved[[0, 2]], base[[0, 2]]) and not torch.equal(moved[1], base[1])

    def poke(cache):
        cache.v[2, 1, :, 3] += 3.0

    moved = run(x, poke)
    assert torch.equal(moved[[0, 1]], base[[0, 1]]) and not torch.equal(moved[2], base[2])


def test_batched_decode_attention_is_routed_per_dtype(monkeypatch):
    """bf16 compute goes through the batched kernel's wrapper; precise-mode f32
    takes the plain version at f32 (the kernel is bf16 only)."""
    calls = []
    real = da.decode_attention_batched
    monkeypatch.setattr(dec, "decode_attention_batched", lambda *a: calls.append(1) or real(*a))
    _, tparams = _params(False, seed=3)
    _, tcache = _caches([1, 2], 16, seed=3)
    _, x = _embeds((2, CFG.embedding_length), seed=3)
    dec.forward_decode_batch(CFG, tparams, x, tcache)
    assert len(calls) == CFG.block_count
    precise = dataclasses.replace(CFG, compute_dtype="float32")
    f32 = dec.init_cache_batch(precise, 2, 16, dtype=torch.float32)
    f32.set_positions([1, 2])
    dec.forward_decode_batch(precise, jax.tree.map(lambda t: t.float() if t.is_floating_point() else t, tparams),
                             x.float(), f32)
    assert len(calls) == CFG.block_count


# -- greedy loop -------------------------------------------------------------------

EOS = 99
POS0 = 4


def _stub_decoders(monkeypatch, schedule):
    """Both packages' forward/logits replaced by a step-indexed emission
    schedule: step i emits ``schedule[i, b]`` for stream b."""
    sched = jnp.asarray(schedule)
    steps = schedule.shape[0]

    def ref_forward(cfg_, params_, x, cache):
        step = cache.pos[0] - POS0
        return jnp.full((x.shape[0], 1), step, jnp.int32), cache._replace(pos=cache.pos + 1)

    def ref_logits(cfg_, params_, hidden):
        return jax.nn.one_hot(sched[jnp.clip(hidden[0, 0], 0, steps - 1)], CFG.vocab_size, dtype=jnp.float32)

    def port_forward(cfg_, params_, x, cache, tp=None):
        step = cache.pos_host[0] - POS0
        cache.advance(1)
        return torch.full((x.shape[0], 1), step)

    def port_logits(cfg_, params_, hidden):
        row = torch.from_numpy(schedule[min(int(hidden[0, 0]), steps - 1)]).long()
        return torch.nn.functional.one_hot(row, CFG.vocab_size).float()

    monkeypatch.setattr(ref_dec, "forward_decode_batch", ref_forward)
    monkeypatch.setattr(ref_dec, "logits_for", ref_logits)
    monkeypatch.setattr(ref_dec, "embed_tokens", lambda params_, ids: jnp.zeros((ids.shape[0], 1)))
    monkeypatch.setattr(dec, "forward_decode_batch", port_forward)
    monkeypatch.setattr(dec, "logits_for", port_logits)
    monkeypatch.setattr(dec, "embed_tokens", lambda params_, ids: torch.zeros(ids.shape[0], 1))


def _schedule(scripts, steps):
    schedule = np.zeros((steps, len(scripts)), np.int32)
    for b, script in enumerate(scripts):
        for i in range(steps):
            schedule[i, b] = script[i] if i < len(script) else 7
    return schedule


@pytest.mark.parametrize("budgets", [None, [2, 8, 3, 0]], ids=["no-budgets", "budgets"])
@pytest.mark.parametrize("max_new", [8, 4])
def test_decode_greedy_batch_matches_jax(monkeypatch, budgets, max_new):
    scripts = [[5, 6, EOS], [7, 8, 9, 10, EOS], [EOS], [11, 12]]
    firsts = [5, 7, EOS, 11]
    schedule = _schedule(scripts, 10)
    _stub_decoders(monkeypatch, schedule)
    B = len(scripts)
    jcache = ref_dec.KVCache(k=jnp.zeros((B, 1)), v=jnp.zeros((B, 1)), pos=jnp.full((B,), POS0, jnp.int32))
    jbudgets = None if budgets is None else jnp.asarray(budgets, jnp.int32)
    want, _ = ref_model._decode_greedy_batch.__wrapped__(
        CFG, {}, jnp.asarray(firsts, jnp.int32), jcache, EOS, max_new, jbudgets)
    tcache = dec.BatchKVCache(k=torch.zeros(B, 1), v=torch.zeros(B, 1), pos=torch.zeros(0), pos_host=[])
    tcache.set_positions([POS0] * B)
    steps = []
    got = port_model._decode_greedy_batch(CFG, {}, torch.tensor(firsts), tcache, EOS, max_new, budgets,
                                          step_times=steps)
    np.testing.assert_array_equal(got, np.asarray(want))
    rows = [[int(t) for t in row if t >= 0] for row in got]
    if budgets is None and max_new == 8:
        assert rows == [[5, 5, 6], [7, 7, 8, 9, 10], [], [11, 11, 12, 7, 7, 7, 7, 7]]
    # one timed forward per step; none after the last recordable token
    assert len(steps) == tcache.pos_host[0] - POS0 <= max_new - 1


def test_decode_greedy_batch_stops_at_once_when_every_stream_starts_done(monkeypatch):
    _stub_decoders(monkeypatch, _schedule([[EOS]], 4))
    tcache = dec.BatchKVCache(k=torch.zeros(2, 1), v=torch.zeros(2, 1), pos=torch.zeros(0), pos_host=[])
    tcache.set_positions([POS0, POS0])
    got = port_model._decode_greedy_batch(CFG, {}, torch.tensor([EOS, 3]), tcache, EOS, 6, budgets=[5, 0])
    assert (got == -1).all() and tcache.pos_host == [POS0, POS0]

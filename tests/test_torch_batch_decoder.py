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
from light_whisper_tpu_torch.models.qwen3_asr import step_graph
from light_whisper_tpu_torch.ops import _build
from light_whisper_tpu_torch.ops import decode_attention as da
from light_whisper_tpu_torch.ops import q8_matmul as q8
from light_whisper_tpu_torch.runtime import tracing

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


# -- the B=1 loop on the batched step ---------------------------------------------------

PROMPT = 6
NO_EOS = -1


def _prompted(quantized: bool, seed: int, capacity: int = 32):
    """Both packages' decoders after the same prompt: (jparams, tparams, jax
    cache, torch cache, the port's first token)."""
    jparams, tparams = _params(quantized, seed)
    ej, et = _embeds((PROMPT, CFG.embedding_length), seed + 1)
    _jh, jcache = ref_dec.forward(CFG, jparams, ej, ref_dec.init_cache(CFG, capacity))
    tcache = dec.init_cache(CFG, capacity)
    th = dec.forward(CFG, tparams, et, tcache)
    return jparams, tparams, jcache, tcache, torch.argmax(dec.logits_for(CFG, tparams, th[-1:])[-1])


def _copy(cache):
    return dec.KVCache(k=cache.k.clone(), v=cache.v.clone(), pos=cache.pos)


def _forward_loop(tparams, first, cache, eos, limit):
    """The B=1 loop as it stepped before: ``forward`` at the host position,
    one stream."""
    out, token = [], first.reshape(1)
    while int(token) != eos and len(out) < limit:
        out.append(int(token))
        if len(out) == limit:
            break
        hidden = dec.forward(CFG, tparams, dec.embed_tokens(tparams, token), cache)
        token = torch.argmax(dec.logits_for(CFG, tparams, hidden[-1:])[-1]).reshape(1)
    return out


@pytest.mark.parametrize("quantized", [True, False], ids=["q8_0", "dense"])
@pytest.mark.parametrize("stop", ["eos", "budget", "max_new_tokens"])
def test_decode_greedy_on_the_batched_step_matches_the_forward_loop_and_jax(quantized, stop):
    """The same ids, cache contents and final ``cache.pos`` as the
    single-stream loop it replaces, and the reference's ids and K/V rows."""
    max_new = 10
    jparams, tparams, jcache, tcache, first = _prompted(quantized, seed=11)
    free = _forward_loop(tparams, first, _copy(tcache), NO_EOS, max_new)
    eos, budget = NO_EOS, None
    if stop == "eos":  # the first id that was not emitted before, from the second on
        eos = next(t for i, t in enumerate(free) if i >= 1 and t not in free[:i])
    elif stop == "budget":
        budget = 4
    limit = max_new if budget is None else budget
    old = _copy(tcache)
    want = _forward_loop(tparams, first, old, eos, limit)
    got = dec.decode_greedy(CFG, tparams, first, tcache, eos, max_new, budget=budget)
    assert got == want
    assert len(got) == max_new if stop == "max_new_tokens" else len(got) < max_new
    assert isinstance(tcache.pos, int) and tcache.pos == old.pos > PROMPT
    assert torch.equal(tcache.k, old.k) and torch.equal(tcache.v, old.v)
    tokens, count, jout = ref_dec.decode_greedy(CFG, jparams, jnp.int32(int(first)), jcache, eos, max_new,
                                                budget=None if budget is None else jnp.int32(budget))
    assert [int(t) for t in np.asarray(tokens)[: int(count)]] == got
    for name in ("k", "v"):
        torch.testing.assert_close(getattr(tcache, name)[:, :, PROMPT : tcache.pos].float(),
                                   _to_torch(getattr(jout, name))[:, :, PROMPT : tcache.pos].float(),
                                   atol=0.05, rtol=0.02)


# -- the captured step's bookkeeping, with a stand-in for the CUDA graph ---------------

SPANS = ("model.decode.step", "model.decode.capture", "model.decode.replay")


class StandInGraph:
    """``step_graph.CudaGraph``'s stand-in on the CPU. A capture here cannot
    defer the body, so ``capture`` runs it and the replay right after does
    nothing; a later replay runs the body and puts the launch counters back
    as they were, since a replay counts nothing in Python."""

    made: list = []

    def __init__(self, device):
        self.pending = self.released = False
        StandInGraph.made.append(self)

    def capture(self, body):
        self.body = body
        body()
        self.pending = True

    def replay(self):
        if self.pending:
            self.pending = False
            return
        counters = (da.LAUNCHES, q8.LAUNCHES)
        before = [dict(c) for c in counters]
        self.body()
        for c, b in zip(counters, before):
            c.update(b)

    def release(self):
        self.released = True


@pytest.fixture
def counted_on_cpu(monkeypatch):
    """The CPU's plain batched attention and fused projections count a launch
    each, as the card's wrappers do; no stand-in yet."""
    for module, name, key in ((da, "decode_attention_batched_plain", "decode_attention_batched"),
                              (q8, "q8_matmul_fused_plain", "q8_matmul_stacked_fused")):
        real = getattr(module, name)

        def counted(*a, _real=real, _module=module, _key=key, **kw):
            _build.count_launch(_module.LAUNCHES, _key)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    StandInGraph.made = []


def _stand_in(monkeypatch):
    """The stand-in graph, and ``graphs_engage`` deciding as it would on a card."""
    engage = dec.graphs_engage
    monkeypatch.setattr(dec, "graphs_engage",
                        lambda cfg, device, steps, tp=dec.Replicated: engage(cfg, torch.device("cuda"), steps, tp))
    monkeypatch.setattr(step_graph, "CudaGraph", StandInGraph)


def _observed(run):
    """``run()``'s result, with the launch counts and span counts it added."""
    launches0 = {**da.LAUNCHES, **q8.LAUNCHES}
    spans0 = tracing.snapshot()
    out = run()
    spans1 = tracing.snapshot()
    launches = {k: v - launches0[k] for k, v in {**da.LAUNCHES, **q8.LAUNCHES}.items()}
    spans = {n: spans1.get(n, {"count": 0})["count"] - spans0.get(n, {"count": 0})["count"] for n in SPANS}
    return out, launches, spans


def _b1_run(tparams, first, cache):
    return lambda: dec.decode_greedy(CFG, tparams, first, cache, NO_EOS, 7)


def _batched_run(tparams, cache, budgets):
    firsts = torch.tensor([3, 9, 17])
    return lambda: port_model._decode_greedy_batch(CFG, tparams, firsts, cache, EOS, 7, budgets=budgets)


@pytest.mark.parametrize("loop", ["b1", "batched"])
def test_a_captured_step_is_replayed_every_step_and_counted_as_launched(counted_on_cpu, monkeypatch, loop):
    """One capture a loop, every step a replay, the launch counters as an
    eager loop leaves them, host positions one ahead a step, ``budgets=``
    and the ``-1`` filling as before, and the graph released at the end."""
    runs = []
    for graphed in (False, True):
        if graphed:
            _stand_in(monkeypatch)
        if loop == "b1":
            _, tparams, _, tcache, first = _prompted(True, seed=21)
            out, launches, spans = _observed(_b1_run(tparams, first, tcache))
            state = (tcache.pos, tcache.k, tcache.v)
        else:
            _, tparams = _params(True, seed=22)
            _, tcache = _caches([3, 17, 0], 32, seed=23)
            out, launches, spans = _observed(_batched_run(tparams, tcache, [2, 8, 0]))
            state = (tcache.pos_host, tcache.pos.tolist(), tcache.k, tcache.v)
        runs.append((out, launches, spans, state))
    (eager, eager_launches, eager_spans, eager_state), (got, launches, spans, state) = runs
    steps = spans["model.decode.step"]
    assert steps == eager_spans["model.decode.step"] == 6
    assert eager_spans["model.decode.capture"] == eager_spans["model.decode.replay"] == 0
    assert spans["model.decode.capture"] == 1 and spans["model.decode.replay"] == steps
    assert len(StandInGraph.made) == 1 and StandInGraph.made[0].released
    assert launches == eager_launches
    assert launches["decode_attention_batched"] == CFG.block_count * steps
    assert launches["q8_matmul_stacked_fused"] == 4 * CFG.block_count * steps
    if loop == "b1":
        assert got == eager and state[0] == eager_state[0] == PROMPT + steps
    else:
        np.testing.assert_array_equal(got, eager)
        assert [int((row >= 0).sum()) for row in got] == [2, 7, 0]  # budgets, and -1 past each stream's end
        assert state[0] == state[1] == eager_state[0] == [3 + steps, 17 + steps, steps]
    assert all(torch.equal(a, b) for a, b in zip(state[-2:], eager_state[-2:]))


class _MeshSeams:
    """A one-rank mesh's seams: the identity, but not ``Replicated``."""

    @staticmethod
    def enter(x):
        return x

    @staticmethod
    def reduce(x):
        return x


@pytest.mark.parametrize("case", ["cpu", "mesh", "f32", "fused_ffn", "one_step"])
def test_the_step_stays_eager_where_graphs_do_not_engage(counted_on_cpu, monkeypatch, case):
    """The CPU, a mesh, f32 compute, a loop of one step and (on the B=1 loop)
    ``LWT_FUSED_FFN`` run eager: no capture, no replay. Every B=1 loop but the
    fused-FFN one steps with the batched forward."""
    cfg, tp = CFG, dec.Replicated
    if case != "cpu":
        _stand_in(monkeypatch)
    else:
        monkeypatch.setattr(step_graph, "CudaGraph", StandInGraph)
    _, tparams = _params(True, seed=31)
    if case == "mesh":
        tp = _MeshSeams
    elif case == "f32":
        cfg = dataclasses.replace(CFG, compute_dtype="float32")
        _, tparams = _params(False, seed=31)
        tparams = jax.tree.map(lambda t: t.float() if t.is_floating_point() else t, tparams)
    elif case == "fused_ffn":
        monkeypatch.setenv("LWT_FUSED_FFN", "1")
    batched_forwards = []
    forward_decode_batch = dec.forward_decode_batch

    def counted(cfg, params, x, cache, *args, **kwargs):
        batched_forwards.append(x.shape[0])
        return forward_decode_batch(cfg, params, x, cache, *args, **kwargs)

    monkeypatch.setattr(dec, "forward_decode_batch", counted)
    steps = 1 if case == "one_step" else 4
    budget, budgets = (2, [1, 1]) if case == "one_step" else (None, None)  # one step in either loop
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    b1 = dec.init_cache(cfg, 32, dtype)
    b1.pos = 4
    batched = dec.init_cache_batch(cfg, 2, 32, dtype)
    batched.set_positions([4, 9])
    spans0 = tracing.snapshot()
    first = dec.decode_greedy(cfg, tparams, torch.tensor(5), b1, NO_EOS, 5, budget=budget, tp=tp)
    assert batched_forwards == ([] if case == "fused_ffn" else [1] * steps)
    loops = [("b1", first)]
    if case != "fused_ffn":  # the opt-in is the B=1 loop's; the batched loop never takes it
        loops.append(("batched", port_model._decode_greedy_batch(cfg, tparams, torch.tensor([5, 6]), batched,
                                                                  EOS, 5, budgets=budgets, tp=tp)))
    spans1 = tracing.snapshot()
    count = {n: spans1.get(n, {"count": 0})["count"] - spans0.get(n, {"count": 0})["count"] for n in SPANS}
    assert count["model.decode.step"] == steps * len(loops)
    assert count["model.decode.capture"] == count["model.decode.replay"] == 0 and not StandInGraph.made
    assert b1.pos == 4 + steps and len(first) == steps + 1
    if case != "fused_ffn":
        assert batched.pos_host == batched.pos.tolist() == [4 + steps, 9 + steps]


def test_graphs_engage_on_a_card_unmeshed_in_bf16_for_two_steps_or_more():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert dec.graphs_engage(CFG, cuda, 2) is True
    assert dec.graphs_engage(CFG, cpu, 2) is False
    assert dec.graphs_engage(CFG, cuda, 2, _MeshSeams) is False
    assert dec.graphs_engage(dataclasses.replace(CFG, compute_dtype="float32"), cuda, 2) is False
    assert dec.graphs_engage(CFG, cuda, 1) is False and dec.graphs_engage(CFG, cuda, 0) is False

"""The port's interim tick (``serving/incremental.py``) against the reference's.

Both packages' ``IncrementalTranscriber`` take the same growing windows of the
same audio on the tiny GGUF fixture (quantized and dense): the tokens of every
tick and the five counters (full, incremental and clip-guard prefills, draft
tokens offered and accepted) must be identical. Each tick must also equal the
port's stateless ``transcribe`` of that window; an argmax flip there is
accepted only inside the 1e-3 top-2 tie band, and its gap is printed.

Then the dictation slice over it: both packages' ``StreamingSession`` ticked
after the same 250 ms blocks of one clip (interim results and the final
equal, under the same tie rule).
"""

import numpy as np
import pytest

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
from light_whisper_tpu.serving import incremental as ref_inc
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.serving import incremental as port_inc

MAX_NEW = 8
TIE_BAND = 1e-3
SR = 16000
COUNTERS = ("full_prefills", "incremental_prefills", "clip_guard_prefills", "draft_tokens_offered",
            "draft_tokens_accepted")


@pytest.fixture(scope="module", params=[True, False], ids=["q8_0", "dense"])
def tiny_path(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("inc") / "tiny.gguf")
    write_tiny_model(path, quantize=request.param, seed=0)
    return path


@pytest.fixture(scope="module")
def models(tiny_path):
    mp = pytest.MonkeyPatch()
    mp.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")
    try:
        yield (RefModel(tiny_path, max_new_tokens=MAX_NEW),
               Qwen3ASRModel(tiny_path, device="cpu", max_new_tokens=MAX_NEW))
    finally:
        mp.undo()


def _noise(seconds, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(int(seconds * SR)) * scale).astype(np.float32)


def _counters(inc):
    return {name: getattr(inc, name) for name in COUNTERS}


def _parting(port, audio, want, got):
    """(step, the port's stateless top-2 gap there) where two token lists part."""
    step = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), min(len(want), len(got)))
    logits = port.teacher_forced_logits(audio, want[:step])[step].numpy()[: port.config.decoder.vocab_size]
    top2 = np.sort(logits)[-2:]
    return step, float(top2[1] - top2[0])


def assert_stateless_within_tie(port, window, got):
    """The tick's tokens against the port's stateless transcribe: equal, or
    parted where the stateless path's top-2 logits lie within the tie band."""
    want = port.transcribe(window).tokens
    if got == want:
        return None
    step, gap = _parting(port, window, want, got)
    print(f"tick parts from stateless at step {step}: top-2 gap {gap:.3g}")
    assert gap <= TIE_BAND, (step, gap, want, got)
    return gap


def _run_ticks(models, windows, starts=None):
    ref, port = models
    r_inc = ref_inc.IncrementalTranscriber(ref, max_new_tokens=MAX_NEW)
    p_inc = port_inc.IncrementalTranscriber(port, max_new_tokens=MAX_NEW)
    starts = starts or [0] * len(windows)
    for window, start in zip(windows, starts):
        want = r_inc.transcribe_window(window, window_start_sample=start)
        got = p_inc.transcribe_window(window, window_start_sample=start)
        assert got.tokens == want.tokens
        assert (got.text, got.language) == (want.text, want.language)
        assert _counters(p_inc) == _counters(r_inc)
        assert p_inc._stable_tokens == r_inc._stable_tokens
        assert_stateless_within_tie(port, window, got.tokens)
    return r_inc, p_inc


def test_growing_windows_match_the_reference(models):
    audio = _noise(9, seed=0)
    _r, p_inc = _run_ticks(models, [audio[: s * SR] for s in (3, 5, 7, 9)])
    assert p_inc.full_prefills == 1 and p_inc.incremental_prefills == 3
    assert p_inc.draft_tokens_offered > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_growth_patterns_match_the_reference(models, seed):
    """Growth from a seed: tiny deltas inside one 0.5 s bucket, single steps
    and bucket jumps, with the level stepping up and down a second at a time
    so that the clip max moves between ticks."""
    rng = np.random.default_rng(100 + seed)
    levels = rng.choice([0.05, 0.3, 0.8], size=10)
    audio = np.concatenate([_noise(1, seed=200 + seed + i, scale=lv) for i, lv in enumerate(levels)])
    n, windows = int(rng.integers(2 * SR, 3 * SR)), []
    while n <= len(audio) and len(windows) < 6:
        windows.append(audio[:n])
        n += int(rng.choice([160, 4000, 8000, 24000]))
    _run_ticks(models, windows)


def test_clip_guard_fires_at_the_same_tick(models):
    quiet = _noise(6, seed=3, scale=0.002)
    loud = _noise(3, seed=4, scale=0.9)
    audio = np.concatenate([quiet, loud])
    r_inc, p_inc = _run_ticks(models, [audio[: 6 * SR], audio, np.concatenate([audio, loud[:SR]])])
    assert p_inc.clip_guard_prefills == 1 == r_inc.clip_guard_prefills
    assert p_inc.full_prefills == 2


def test_window_slide_forces_a_full_prefill(models):
    audio = _noise(6, seed=5)
    _r, p_inc = _run_ticks(models, [audio[: 5 * SR], audio[SR:]], starts=[0, SR])
    assert p_inc.full_prefills == 2 and p_inc.incremental_prefills == 0


def test_reset_clears_the_state(models):
    ref, port = models
    audio = _noise(5, seed=6)
    p_inc = port_inc.IncrementalTranscriber(port, max_new_tokens=MAX_NEW)
    first = p_inc.transcribe_window(audio).tokens
    p_inc.reset()
    assert p_inc._cache is None and p_inc._last_generated == [] and p_inc._clip_max is None
    assert p_inc.transcribe_window(audio).tokens == first
    assert p_inc.full_prefills == 2 and p_inc.incremental_prefills == 0


def test_a_failed_tick_resets_the_session(models, monkeypatch):
    _ref, port = models
    p_inc = port_inc.IncrementalTranscriber(port, max_new_tokens=MAX_NEW)
    audio = _noise(6, seed=7)
    p_inc.transcribe_window(audio[: 5 * SR])

    def boom(*args, **kwargs):
        raise RuntimeError("segment failed")

    monkeypatch.setattr(port_inc, "_encode_prefill_segment", boom)
    with pytest.raises(RuntimeError, match="segment failed"):
        p_inc.transcribe_window(audio)
    assert p_inc._cache is None
    monkeypatch.undo()
    assert p_inc.transcribe_window(audio).tokens == port.transcribe(audio).tokens
    assert p_inc.full_prefills == 2


def test_stable_boundary_and_capacity_match_the_reference(models):
    ref, port = models
    r_inc = ref_inc.IncrementalTranscriber(ref, max_new_tokens=MAX_NEW)
    p_inc = port_inc.IncrementalTranscriber(port, max_new_tokens=MAX_NEW)
    for n in list(range(0, 12 * SR, 997)) + [4 * SR - 200, 4 * SR - 199, 4 * SR, 8 * SR + 200]:
        n_audio = port._audio_tokens_for(n)
        assert n_audio == ref._audio_tokens_for(n)
        assert p_inc._stable_boundary(n, n_audio) == r_inc._stable_boundary(n, n_audio), n
    for needed in (1, 511, 512, 513, 1024, 1025, 4097, 20000):
        assert port_inc.cache_capacity_for(needed) == ref_inc.cache_capacity_for(needed)
    for name in ("SEGMENT_BUCKET", "INTERIM_MAX_NEW_TOKENS", "DRAFT_TOKENS", "CLIP_MAX_EPS"):
        assert getattr(port_inc, name) == getattr(ref_inc, name)


@pytest.mark.parametrize("budget", [0, 1, 3, None])
def test_decode_greedy_budget_matches_the_reference(models, budget):
    import jax.numpy as jnp
    import torch

    from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec
    from light_whisper_tpu.models.qwen3_asr.model import _encode_and_prefill
    from light_whisper_tpu_torch.models.qwen3_asr import decoder as port_dec

    ref, port = models
    audio = _noise(2, seed=8)
    padded, n_audio, ids, true_len, mel_frames, num_chunks = port._prepare(audio)
    cache = port._cache_for(len(ids) + MAX_NEW)
    logits, _clip = port._encode_and_prefill(padded, n_audio, ids, true_len, mel_frames, num_chunks, cache)
    got = port_dec.decode_greedy(port.config.decoder, port.decoder_params, torch.argmax(logits), cache,
                                 port.config.eos_token_id, MAX_NEW, budget=budget)

    r_cache = ref._cache_for(len(ids) + MAX_NEW)
    first, r_cache, _clip = _encode_and_prefill(
        ref.config, ref.encoder_params, ref.decoder_params, jnp.asarray(padded), jnp.int32(n_audio),
        jnp.asarray(ids.astype(np.int32)), jnp.int32(true_len - 1), r_cache, num_chunks, mel_frames,
        len(ref.prefix_ids))
    r_cache = r_cache._replace(pos=jnp.int32(true_len))
    tokens, count, _ = ref_dec.decode_greedy(ref.config.decoder, ref.decoder_params, first, r_cache,
                                             ref.config.eos_token_id, MAX_NEW,
                                             budget=None if budget is None else jnp.int32(budget))
    want = [int(t) for t in np.asarray(tokens)[: int(count)]]
    assert got == want
    assert len(got) <= (MAX_NEW if budget is None else budget)


def test_forward_refuses_a_write_past_the_capacity(models):
    import torch

    from light_whisper_tpu_torch.models.qwen3_asr import decoder as port_dec

    _ref, port = models
    cfg = port.config.decoder
    cache = port_dec.init_cache(cfg, 64, port.cache_dtype)
    embeds = torch.zeros(8, cfg.embedding_length, dtype=torch.bfloat16)
    cache.pos = 60
    with pytest.raises(ValueError, match="exceed the cache capacity"):
        port_dec.forward(cfg, port.decoder_params, embeds, cache)
    assert cache.pos == 60 and not bool(cache.k.any())
    cache.pos = 56
    port_dec.forward(cfg, port.decoder_params, embeds, cache)
    assert cache.pos == 64


# -- the dictation slice: StreamingSession over the tick, without threads or a clock


def _same_or_tie(port, audio, what, want_text, got_text, want_tokens, got_tokens):
    """True if equal; False after a flip inside the tie band (printed); fails
    on any other difference."""
    if got_text == want_text:
        return True
    step, gap = _parting(port, audio, want_tokens, got_tokens)
    print(f"{what}: the packages part at token {step}, top-2 gap {gap:.3g}")
    assert gap <= TIE_BAND, (what, step, gap, want_text, got_text)
    return False


@pytest.mark.parametrize("ticks_after,reuse", [((3, 6, 8), True), ((3, 6), False)],
                         ids=["interim-cache", "full-transcribe"])
def test_streaming_session_matches_the_reference(models, ticks_after, reuse):
    """Both packages' ``StreamingSession(IncrementalTranscriber(model))`` take
    the same 2 s clip in 250 ms blocks and tick after the same blocks: every
    interim result and the final result are equal. Ticking after the last
    block leaves a tail gap of 0 (the final reuses the last tick); stopping
    two blocks short leaves 0.5 s (the final transcribes the whole clip).
    Clip seed 12: on seed 11's first 0.75 s the two packages' stateless
    ``transcribe`` already part, at token 3 with a top-2 gap of 6.8e-3 (logits
    near 1.06, under one bf16 ulp there), the tiny fixture's recorded near-tie
    class (ROADMAP §3), before any streaming code runs."""
    from light_whisper_tpu.serving import streaming as ref_streaming
    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.serving import streaming as port_streaming

    ref, port = models
    audio = speechlike(2.0, seed=12)
    r_inc = ref_inc.IncrementalTranscriber(ref, max_new_tokens=MAX_NEW)
    p_inc = port_inc.IncrementalTranscriber(port, max_new_tokens=MAX_NEW)
    r_session, p_session = ref_streaming.StreamingSession(r_inc), port_streaming.StreamingSession(p_inc)
    block = SR // 4
    for k in range(1, len(audio) // block + 1):
        r_session.accept(audio[(k - 1) * block : k * block])
        p_session.accept(audio[(k - 1) * block : k * block])
        if k not in ticks_after:
            continue
        want, got = r_session.tick(), p_session.tick()
        if not _same_or_tie(port, audio[: k * block], f"tick after block {k}", want.text, got.text,
                            r_inc._last_generated, p_inc._last_generated):
            return  # parted at a tie: later ticks verify different drafts
        assert (got.stable, got.tentative, got.covered_samples) == (want.stable, want.tentative,
                                                                     want.covered_samples)
    want, got = r_session.finalize(), p_session.finalize()
    assert got.from_interim_cache is want.from_interim_cache is reuse
    if _same_or_tie(port, audio, "final", want.text, got.text, r_inc._last_generated, p_inc._last_generated):
        assert got.language == want.language
    assert (p_inc.full_prefills, p_inc.incremental_prefills) == (r_inc.full_prefills, r_inc.incremental_prefills)
    assert p_inc.full_prefills >= 1 and p_inc.incremental_prefills >= 1

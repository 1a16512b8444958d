"""The slice end to end: the port's ``Qwen3ASRModel.transcribe`` against the
JAX package's on the same GGUF and the same audio.

Greedy tokens must be identical. A divergence is accepted only inside the
~1e-3 top-2 tie band of the exactness doctrine (docs/SERVING.md): the port's
logits at the first differing step, teacher-forced on the common prefix, must
have their top-2 within 1e-3, and the test reports the gap.
"""

import numpy as np
import pytest

from helpers.tiny_model import tiny_tensors, tiny_vocab, write_tiny_model
from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.models.qwen3_asr.config import AudioEncoderConfig, DecoderConfig, Qwen3ASRConfig
from light_whisper_tpu.models.qwen3_asr.export import write_model
from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
from light_whisper_tpu_torch.models.qwen3_asr import model as port_model
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

MAX_NEW = 8
TIE_BAND = 1e-3


def narrow_config() -> Qwen3ASRConfig:
    """Small widths with the flagship's head geometry: hd=128, G=2."""
    tokens, _ = tiny_vocab()
    vocab = len(tokens)
    return Qwen3ASRConfig(
        audio=AudioEncoderConfig(num_mel_bins=128, d_model=64, block_count=2, head_count=2,
                                 feed_forward_length=128, downsample_hidden_size=16, output_dim=256,
                                 max_source_positions=200),
        decoder=DecoderConfig(vocab_size=vocab, embedding_length=256, block_count=2,
                              feed_forward_length=256, head_count=4, head_count_kv=2, key_length=128,
                              context_length=4096),
        audio_token_id=vocab - 3, bos_token_id=vocab - 5, eos_token_id=vocab - 4, pad_token_id=vocab - 6,
    )


def _write_narrow(path: str, seed: int) -> None:
    cfg = narrow_config()
    tokens, types = tiny_vocab()
    meta = {"tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.merges": [],
            "tokenizer.chat_template": "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n"}
    write_model(path, cfg, tiny_tensors(cfg, seed=seed), meta, quantize=True)


def _assert_same_greedy(port, ref_tokens, got_tokens, audio):
    if got_tokens == ref_tokens:
        return
    step = next(i for i, (a, b) in enumerate(zip(ref_tokens, got_tokens)) if a != b) \
        if any(a != b for a, b in zip(ref_tokens, got_tokens)) else min(len(ref_tokens), len(got_tokens))
    logits = port.teacher_forced_logits(audio, ref_tokens[:step])[step]
    top2 = np.sort(logits.numpy()[: port.config.decoder.vocab_size])[-2:]
    gap = float(top2[1] - top2[0])
    print(f"greedy paths part at step {step}: top-2 gap {gap:.3g}")
    assert gap <= TIE_BAND, (step, gap, ref_tokens, got_tokens)


@pytest.fixture(autouse=True)
def _no_shadow_warmup(monkeypatch):
    # no load-overlapped warmup thread may outlive a test
    monkeypatch.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quantize", [True, False], ids=["q8_0", "dense"])
def test_tiny_fixture_greedy_tokens_identical(tmp_path, quantize, seed):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_model(path, quantize=quantize, seed=seed)
    audio = speechlike(2.0, seed=seed + 1)
    ref = RefModel(path, max_new_tokens=MAX_NEW).transcribe(audio)
    port = Qwen3ASRModel(path, device="cpu", max_new_tokens=MAX_NEW)
    got = port.transcribe(audio)
    _assert_same_greedy(port, ref.tokens, got.tokens, audio)
    assert (got.text, got.language) == (ref.text, ref.language)


@pytest.mark.parametrize("seconds", [2.0, 5.5])
def test_narrow_hd128_greedy_tokens_identical(tmp_path, seconds):
    """hd=128, G=2: prefill rows reach the attention kernel's path (T<=64 at
    2 s, the plain path at 5.5 s) and decode the fused Q8 forms."""
    path = str(tmp_path / "narrow.gguf")
    _write_narrow(path, seed=7)
    audio = speechlike(seconds, seed=9)
    ref = RefModel(path, max_new_tokens=MAX_NEW).transcribe(audio)
    port = Qwen3ASRModel(path, device="cpu", max_new_tokens=MAX_NEW)
    got = port.transcribe(audio)
    _assert_same_greedy(port, ref.tokens, got.tokens, audio)


def test_int16_and_float_audio_give_the_same_tokens(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=3)
    port = Qwen3ASRModel(path, device="cpu", max_new_tokens=4)
    pcm = np.round(speechlike(1.5, seed=4) * 32767).astype(np.int16)
    assert port.transcribe(pcm).tokens == port.transcribe(pcm.astype(np.float32) / 32768.0).tokens


def test_shape_rules_match_the_reference():
    from light_whisper_tpu.models.qwen3_asr import model as ref_model

    assert port_model.PROMPT_BUCKET == ref_model.PROMPT_BUCKET
    for n in (1, 7999, 8000, 8001, 16 * 16000, 16 * 16000 + 1, 100 * 16000):
        assert port_model.bucket_audio_samples(n) == ref_model.bucket_audio_samples(n)
    rng = np.random.default_rng(0)
    for audio in (np.round(rng.standard_normal(100) * 1000) / 32768.0, rng.standard_normal(100),
                  np.zeros(0, np.float32), np.arange(5, dtype=np.int16)):
        want = ref_model.as_device_audio(audio.astype(audio.dtype))
        got = port_model.as_device_audio(audio)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_kv_capacity_is_a_power_of_two_from_1024(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=0)
    port = Qwen3ASRModel(path, device="cpu", max_new_tokens=4)
    assert port._cache_for(10).k.shape[2] == 1024
    assert port._cache_for(1025).k.shape[2] == 2048
    with pytest.raises(ValueError, match="exceeds context"):
        port._cache_for(port.config.decoder.context_length + 1)

"""The port's ``Qwen3ASRModel.transcribe_batch`` against the JAX package's on
the same tiny GGUF fixtures and the same clips: greedy tokens identical, for
Q8_0 and dense weights, three seeds, clips of mixed lengths, in one batch and
in chunks of two (``LWT_MAX_DECODE_BATCH=2``), plus the empty and one-clip
cases and a context overflow, which both packages refuse with ``ValueError``.

Clips of different lengths are encoded with the longest clip's padded
bucket's valid-token count (the reference's ``_encode_padded``), so a short
clip's batched tokens may differ from its per-stream ``transcribe``: that is
the reference's behaviour, which the port keeps (ROADMAP §3).
"""

import numpy as np
import pytest

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
from light_whisper_tpu_torch.models.qwen3_asr import model as port_model
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

MAX_NEW = 8


@pytest.fixture(autouse=True)
def _no_shadow_warmup(monkeypatch):
    # no load-overlapped warmup thread may outlive a test
    monkeypatch.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")


def _clips(seed):
    return [speechlike(seconds, seed=seed + i) for i, seconds in enumerate((2.0, 3.3, 1.2))]


def _models(tmp_path, quantize, seed, max_new=MAX_NEW):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_model(path, quantize=quantize, seed=seed)
    return RefModel(path, max_new_tokens=max_new), Qwen3ASRModel(path, device="cpu", max_new_tokens=max_new)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quantize", [True, False], ids=["q8_0", "dense"])
def test_transcribe_batch_tokens_identical(tmp_path, quantize, seed):
    ref, port = _models(tmp_path, quantize, seed)
    clips = _clips(seed + 10)
    want = ref.transcribe_batch(clips)
    got = port.transcribe_batch(clips)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [(r.text, r.language) for r in got] == [(r.text, r.language) for r in want]
    assert len(port.last_decode_step_s) == MAX_NEW - 1  # random weights: no EOS, one forward a step


@pytest.mark.parametrize("long_clip", [False, True], ids=["prompt-64", "prompt-128"])
def test_narrow_hd128_batch_tokens_identical(tmp_path, long_clip):
    """hd 128, G 2: the batched prefill's 64-row prompts reach the unstacked
    attention's path (its plain version here), a 5.5 s clip pushes the prompt
    bucket to 128 rows and the plain softmax; decode runs the batched
    attention's plain version and the fused Q8 forms at B = 2 and 3."""
    from test_torch_model import _write_narrow

    path = str(tmp_path / "narrow.gguf")
    _write_narrow(path, seed=8)
    clips = [speechlike(s, seed=30 + i) for i, s in enumerate((2.0, 1.5) + ((5.5,) if long_clip else ()))]
    want = RefModel(path, max_new_tokens=MAX_NEW).transcribe_batch(clips)
    got = Qwen3ASRModel(path, device="cpu", max_new_tokens=MAX_NEW).transcribe_batch(clips)
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_batched_tokens_follow_the_reference_not_per_stream(tmp_path):
    """``_encode_padded`` masks every clip by the batch bucket's token count:
    a 2.0 s clip batched with a 3.3 s one is encoded over 3.5 s, and its tokens
    differ from its own ``transcribe``, in the reference as in the port."""
    ref, port = _models(tmp_path, True, seed=0)
    clips = [speechlike(2.0, seed=1), speechlike(3.3, seed=2)]
    ref_batch, port_batch = ref.transcribe_batch(clips), port.transcribe_batch(clips)
    assert [r.tokens for r in port_batch] == [r.tokens for r in ref_batch]
    solo = port.transcribe(clips[0]).tokens
    assert solo == ref.transcribe(clips[0]).tokens
    assert port_batch[0].tokens != solo


@pytest.mark.parametrize("quantize", [True, False], ids=["q8_0", "dense"])
def test_chunked_batches_match(tmp_path, monkeypatch, quantize):
    """Three clips in chunks of two: the reference pads the tail chunk with
    row 0, the port runs it at B = 1; the tokens are the same."""
    monkeypatch.setenv("LWT_MAX_DECODE_BATCH", "2")
    assert port_model.max_decode_batch() == 2
    ref, port = _models(tmp_path, quantize, seed=4)
    clips = _clips(20)
    assert [r.tokens for r in port.transcribe_batch(clips)] == [r.tokens for r in ref.transcribe_batch(clips)]


def test_empty_and_single_clip(tmp_path):
    ref, port = _models(tmp_path, True, seed=5)
    assert port.transcribe_batch([]) == [] == ref.transcribe_batch([])
    clip = speechlike(1.7, seed=3)
    (one,) = port.transcribe_batch([clip])
    assert one.tokens == port.transcribe(clip).tokens == ref.transcribe_batch([clip])[0].tokens


def test_context_overflow_raises_as_the_reference_does(tmp_path):
    # tiny context 2048: a 2,100-token budget cannot fit
    ref, port = _models(tmp_path, True, seed=6, max_new=2100)
    clips = _clips(30)[:2]
    with pytest.raises(ValueError, match="exceeds context"):
        ref.transcribe_batch(clips)
    with pytest.raises(ValueError, match="exceeds context"):
        port.transcribe_batch(clips)


def test_int16_and_float_clips_mix(tmp_path):
    """Wire clips arrive as int16; a float clip in the same batch is scaled to
    one array without changing either's tokens."""
    _ref, port = _models(tmp_path, True, seed=7)
    clips = _clips(40)[:2]
    pcm = [np.round(c * 32767).astype(np.int16) for c in clips]
    as_float = [p.astype(np.float32) / 32768.0 for p in pcm]
    want = [r.tokens for r in port.transcribe_batch(as_float)]
    assert [r.tokens for r in port.transcribe_batch(pcm)] == want
    assert [r.tokens for r in port.transcribe_batch([pcm[0], as_float[1]])] == want


def test_max_decode_batch_reads_the_environment(monkeypatch):
    from light_whisper_tpu.models.qwen3_asr import model as ref_model

    for value in ("3", "0", "junk", ""):
        monkeypatch.setenv("LWT_MAX_DECODE_BATCH", value)
        assert port_model.max_decode_batch() == ref_model.max_decode_batch()
    monkeypatch.delenv("LWT_MAX_DECODE_BATCH")
    assert port_model.max_decode_batch() == 8

"""Port FireRedVAD (fbank + DFSMN in torch) against ``FireRedVadTPU`` running
its host numpy cascade on the CPU: probabilities within atol 1e-4 and
identical speech segments, on speech-like audio and on silence."""

import numpy as np
import pytest
import torch

from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.models.vad.api import FireRedVadTPU
from light_whisper_tpu_torch.models.vad import dfsmn
from light_whisper_tpu_torch.models.vad.api import FireRedVad


@pytest.fixture(scope="module")
def vads():
    return FireRedVadTPU(), FireRedVad(device="cpu")


def _audio(kind):
    if kind == "speech":
        return speechlike(3.0, seed=2)
    if kind == "speech_in_silence":
        return np.concatenate([np.zeros(16000, np.float32), speechlike(2.0, seed=3),
                               np.zeros(12000, np.float32)])
    if kind == "long_speech":
        return speechlike(12.0, seed=4)
    return np.zeros(3 * 16000, np.float32)


@pytest.mark.parametrize("kind", ["speech", "speech_in_silence", "long_speech", "silence"])
def test_probabilities_and_segments_match(vads, kind):
    ref, port = vads
    audio = _audio(kind)
    want = ref.probabilities(audio)
    got = port.probabilities(audio)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert port.speech_timestamps(audio) == ref.speech_timestamps(audio)
    if kind == "silence":
        assert port.speech_timestamps(audio) == []
    else:
        assert port.speech_timestamps(audio)


def test_short_audio_has_no_frames(vads):
    assert vads[1].probabilities(np.zeros(100, np.float32)).shape == (0,)


def test_masked_frames_match_the_unpadded_pass(vads):
    """Padding the features and masking the tail leaves the valid frames as the
    unpadded pass computes them (the memory blocks zero masked frames)."""
    port = vads[1]
    feat = torch.randn(300, 80, generator=torch.Generator().manual_seed(0))
    full = dfsmn.dfsmn_probs(port._params, feat, 300)
    padded = torch.cat([feat, torch.randn(60, 80)])
    torch.testing.assert_close(dfsmn.dfsmn_probs(port._params, padded, 300)[:300], full)

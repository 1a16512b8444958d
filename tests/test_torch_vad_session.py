"""The port's ``VadPrefixSession`` (the reference's halo path) on a growing buffer.

Every tick of a growing buffer must equal the port's stateless
``FireRedVad.probabilities`` of the same buffer within 1e-5, and the
reference's stateless probabilities within the 1e-4 that
``tests/test_torch_vad.py`` holds the port's VAD to; segments must be the
reference's. ``reused_ticks`` counts the ticks that extended the previous
buffer; shrunk or different audio, or audio over 16 s, recomputes fresh.
"""

import numpy as np
import pytest

from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.models.vad import api as ref_api
from light_whisper_tpu.models.vad.api import FireRedVadTPU
from light_whisper_tpu_torch.models.vad import api as port_api
from light_whisper_tpu_torch.models.vad.api import FireRedVad, VadPrefixSession

SR = 16000


@pytest.fixture(scope="module")
def vads():
    return FireRedVadTPU(), FireRedVad(device="cpu")


def _recording(seed):
    return np.concatenate([np.zeros(SR // 2, np.float32), speechlike(4.0, seed=seed), np.zeros(SR // 2, np.float32),
                           speechlike(3.0, seed=seed + 1)])


def test_constants_match_the_reference():
    assert port_api._HALO_FRAMES == ref_api._HALO_FRAMES
    assert port_api._FINE_MAX == ref_api._FINE_MAX


@pytest.mark.parametrize("seed", [0, 1])
def test_growing_buffer_matches_stateless_passes(vads, seed):
    ref, port = vads
    session = VadPrefixSession(port)
    audio = _recording(seed)
    rng = np.random.default_rng(seed)
    n, ticks = 2 * SR, 0
    while n <= len(audio) and ticks < 14:
        window = audio[:n]
        got = session.probabilities(window)
        np.testing.assert_allclose(got, port.probabilities(window), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, ref.probabilities(window), atol=1e-4, rtol=0)
        assert session.speech_timestamps(window) == ref.speech_timestamps(window)
        ticks += 2  # probabilities and speech_timestamps: one extends, one repeats the buffer
        assert session.reused_ticks == ticks - 1
        n += int(rng.choice([160, 8000, 16000]))  # one frame, half a second, a second
    assert session.retained_bytes() == window.nbytes + got.nbytes


def test_shrunk_or_different_audio_recomputes_fresh(vads):
    _ref, port = vads
    session = VadPrefixSession(port)
    audio = _recording(2)
    session.probabilities(audio[: 4 * SR])
    session.probabilities(audio[: 5 * SR])
    assert session.reused_ticks == 1
    shrunk = session.probabilities(audio[: 3 * SR])  # shorter: fresh
    np.testing.assert_array_equal(shrunk, port.probabilities(audio[: 3 * SR]))
    other = audio[: 4 * SR].copy()
    other[100] += 0.01  # not a byte extension of what is held: fresh
    np.testing.assert_array_equal(session.probabilities(other), port.probabilities(other))
    assert session.reused_ticks == 1
    session.probabilities(np.concatenate([other, audio[4 * SR : 5 * SR]]))
    assert session.reused_ticks == 2


def test_audio_over_16_s_recomputes_fresh_and_is_not_kept(vads):
    _ref, port = vads
    session = VadPrefixSession(port)
    audio = np.concatenate([_recording(3), speechlike(8.5, seed=9)])
    assert len(audio) > port_api._FINE_MAX
    session.probabilities(audio[: 15 * SR])
    long = session.probabilities(audio)
    np.testing.assert_array_equal(long, port.probabilities(audio))
    assert session.reused_ticks == 0 and session.retained_bytes() == 0
    session.probabilities(audio[: 15 * SR])
    assert session.reused_ticks == 0 and session.retained_bytes() > 0

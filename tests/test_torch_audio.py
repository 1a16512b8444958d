"""Port front ends against the JAX package: Whisper log-mel and kaldi fbank.

Same numpy-seeded waveforms through both; atol 1e-4 (FFT libraries differ in
the last bits). The numpy tables (mel filterbank, windows) are re-implemented
in the port and must match exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_whisper_tpu.audio import fbank as ref_fbank
from light_whisper_tpu.audio import mel as ref_mel
from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu_torch.audio import fbank as port_fbank
from light_whisper_tpu_torch.audio import mel as port_mel

ATOL = 1e-4


def _speech_i16(seconds, seed):
    return np.round(speechlike(seconds, seed=seed) * 32767.0).astype(np.int16)


def test_numpy_tables_match_exactly():
    np.testing.assert_array_equal(port_mel.whisper_mel_matrix(), ref_mel.whisper_mel_matrix())
    np.testing.assert_array_equal(port_mel.hann_window(), ref_mel.hann_window())
    np.testing.assert_array_equal(port_fbank.kaldi_mel_matrix(), ref_fbank.kaldi_mel_matrix())
    np.testing.assert_array_equal(port_fbank.povey_window(), ref_fbank.povey_window())
    for n in (0, 399, 400, 16000, 16161):
        assert port_mel.num_mel_frames(n) == ref_mel.num_mel_frames(n)
        assert port_fbank.num_frames(n) == ref_fbank.num_frames(n)


@pytest.mark.parametrize("kind", ["float32", "int16", "quiet", "silence"])
def test_log_mel_with_max(kind):
    rng = np.random.default_rng(3)
    if kind == "float32":
        wave = (rng.standard_normal(24000) * 0.1).astype(np.float32)
    elif kind == "int16":
        wave = _speech_i16(1.5, seed=2)
    elif kind == "quiet":
        wave = np.concatenate([np.zeros(8000), rng.standard_normal(8000) * 1e-4]).astype(np.float32)
    else:
        wave = np.zeros(16000, np.float32)
    frames = ref_mel.num_mel_frames(len(wave))
    want, want_max = ref_mel._log_mel_with_max(jnp.asarray(wave), frames)
    got, got_max = port_mel.log_mel_with_max(torch.from_numpy(wave), frames)
    assert got.shape == (frames, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(got_max), float(want_max), atol=ATOL, rtol=0)


def test_int16_path_equals_scaled_float_path():
    wave = _speech_i16(1.0, seed=4)
    frames = port_mel.num_mel_frames(len(wave))
    a, _ = port_mel.log_mel_with_max(torch.from_numpy(wave), frames)
    b, _ = port_mel.log_mel_with_max(torch.from_numpy(wave.astype(np.float32) / 32768.0), frames)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_log_mel_of_several_clips_matches_the_reference_clip_by_clip():
    """``log_mel`` over ``[B, N]`` clamps each clip at its own max, as the
    reference's ``log_mel`` does for each clip alone; N < 160 gives no frame."""
    rng = np.random.default_rng(5)
    waves = np.stack([speechlike(1.5, seed=6), (rng.standard_normal(24000) * 1e-3).astype(np.float32),
                      np.zeros(24000, np.float32)])
    got = port_mel.log_mel(torch.from_numpy(waves))
    assert got.shape == (3, 150, 128)
    for b, wave in enumerate(waves):
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref_mel.log_mel(wave)), atol=ATOL, rtol=0)
    assert port_mel.log_mel(np.zeros((2, 100), np.float32)).shape == (2, 0, 128)


@pytest.mark.parametrize("n", [8000, 8160, 24000])
def test_mel_rows_follow_the_frame_count(n):
    """One row per hop of the (bucketed) waveform, the last centred frame dropped."""
    mel, _ = port_mel.log_mel_with_max(torch.zeros(n), port_mel.num_mel_frames(n))
    assert mel.shape == (n // 160, 128)


@pytest.mark.parametrize("kind", ["speech", "noise", "silence", "short"])
def test_fbank_matches(kind):
    """Against the reference's float64 oracle at atol 1e-4, and against its
    jitted f32 pipeline at 5e-4: that pipeline's own error against the oracle
    reaches ~2e-4 in quiet bins of speech-like audio (the port computes the
    features in float64)."""
    rng = np.random.default_rng(5)
    if kind == "speech":
        wave = _speech_i16(2.0, seed=6).astype(np.float32)
    elif kind == "noise":
        wave = (rng.standard_normal(12345) * 3000).astype(np.float32)
    elif kind == "silence":
        wave = np.zeros(8000, np.float32)
    else:
        wave = np.ones(300, np.float32)
    got = port_fbank.fbank(torch.from_numpy(wave)).numpy()
    oracle = ref_fbank.fbank_reference_np(wave)
    assert got.shape == oracle.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ref_fbank.fbank(wave)), atol=5e-4, rtol=0)

"""Synthetic speech-like audio that the bundled FireRedVAD accepts as speech.

The port's copy of ``light_whisper_tpu/eval/speechlike.py``.

Static harmonic stacks — even with formant emphasis — score ~0.45 max
probability and are rejected; the DFSMN keys on spectral *dynamics*. This
prosodic source-filter generator (time-varying F0, moving formants, syllabic
envelope, int16 round-trip) saturates it (~1.0), so tests and wire drives can
exercise the full VAD→mel→encoder→decoder path without real recordings.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16_000


def speechlike(seconds: float, *, seed: int = 1, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Return float32 mono audio in [-1, 1] that real-weight VAD accepts."""
    n = int(sr * seconds)
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)

    # Glottal-ish source: 25 harmonics of a wandering F0 (prosody + vibrato).
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.8 * t) + 15 * np.sin(2 * np.pi * 3.1 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    src = np.zeros(n)
    for k in range(1, 25):
        src += (1.0 / k) * np.sin(k * phase)

    # Vocal-tract filter: per-50ms overlap-add FFT shaping with moving formants.
    frame = 800
    out = np.zeros(n)
    freqs = np.fft.rfftfreq(frame, 1 / sr)
    window = np.hanning(frame)
    for i in range(0, n - frame, frame // 2):
        f1 = 500 + 200 * np.sin(2 * np.pi * 2.3 * (i / sr))
        f2 = 1500 + 600 * np.sin(2 * np.pi * 1.7 * (i / sr) + 1)
        shape = (
            np.exp(-(((freqs - f1) / 250) ** 2))
            + 0.7 * np.exp(-(((freqs - f2) / 350) ** 2))
            + 0.3 * np.exp(-(((freqs - 2800) / 500) ** 2))
            + 0.02
        )
        spectrum = np.fft.rfft(src[i : i + frame] * window)
        out[i : i + frame] += np.fft.irfft(spectrum * shape, frame)

    peak = np.abs(out).max() or 1.0
    out += 0.02 * rng.standard_normal(n) * (np.abs(out) / peak)  # aspiration
    envelope = 0.55 + 0.45 * np.clip(np.sin(2 * np.pi * 4 * t), -0.8, 1)
    x = out * envelope
    x = 0.85 * x / (np.abs(x).max() or 1.0)
    # int16 round-trip: gives the quantization noise floor real captures have.
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    return (pcm.astype(np.float32) / 32768.0).astype(np.float32)

"""Synthetic speech-like audio that the bundled FireRedVAD accepts as speech.

The port's ``eval/speechlike.py``, kept with the benchmark so that a change
to the program cannot move the traffic. Made faster, the same signal to
rounding (the harmonics by a recurrence, one FFT call for all frames), and
given a ``voice``: the original has one, so every clip said nearly the same
and a model's answer barely followed its audio.

Static harmonic stacks — even with formant emphasis — score ~0.45 max
probability and are rejected; the DFSMN keys on spectral *dynamics*. This
prosodic source-filter generator (time-varying F0, moving formants, syllabic
envelope, int16 round-trip) saturates it (~1.0), so tests and wire drives can
exercise the full VAD→mel→encoder→decoder path without real recordings.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16_000

# The original's one voice: F0 120 Hz swinging 40 Hz at 0.8 Hz with 15 Hz of
# vibrato at 3.1 Hz; F1 500 +- 200 Hz at 2.3 Hz, F2 1500 +- 600 Hz at 1.7 Hz,
# a fixed 2800 Hz band; syllables at 4 Hz.
VOICE = {"f0": 120.0, "f0_swing": 40.0, "f0_rate": 0.8, "vibrato": 15.0, "vibrato_rate": 3.1, "f1": 500.0,
         "f1_swing": 200.0, "f1_rate": 2.3, "f2": 1500.0, "f2_swing": 600.0, "f2_rate": 1.7, "f3": 2800.0,
         "syllable_rate": 4.0, "phases": (0.0, 0.0, 0.0, 1.0, 0.0)}


def voice(rng: np.random.Generator) -> dict:
    """A voice drawn about the original's: F0 from a low male to a high
    female voice, each rate and formant within about a third of its value,
    and the phases of the five movements. What the clips say differs
    (different prompts to the model), and each stays speech to the VAD."""
    u = lambda lo, hi: float(rng.uniform(lo, hi))  # noqa: E731
    f0 = u(95.0, 220.0)
    return {"f0": f0, "f0_swing": f0 * u(0.2, 0.4), "f0_rate": u(0.5, 1.1), "vibrato": f0 * u(0.08, 0.15),
            "vibrato_rate": u(2.5, 3.7), "f1": u(400.0, 650.0), "f1_swing": u(120.0, 220.0), "f1_rate": u(1.6, 3.0),
            "f2": u(1200.0, 1900.0), "f2_swing": u(350.0, 650.0), "f2_rate": u(1.2, 2.2), "f3": u(2500.0, 3100.0),
            "syllable_rate": u(3.0, 5.0), "phases": tuple(u(0.0, 2 * np.pi) for _ in range(5))}


def speechlike(seconds: float, *, seed: int = 1, sr: int = SAMPLE_RATE, voice: dict = VOICE) -> np.ndarray:
    """Return float32 mono audio in [-1, 1] that real-weight VAD accepts."""
    n = int(sr * seconds)
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    v = voice
    ph = v["phases"]

    # Glottal-ish source: 24 harmonics of a wandering F0 (prosody + vibrato).
    f0 = (v["f0"] + v["f0_swing"] * np.sin(2 * np.pi * v["f0_rate"] * t + ph[0])
          + v["vibrato"] * np.sin(2 * np.pi * v["vibrato_rate"] * t + ph[1]))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    # sin(k*phase) by the recurrence s_k = 2 cos(phase) s_{k-1} - s_{k-2}
    two_cos, prev, cur = 2.0 * np.cos(phase), np.zeros(n), np.sin(phase)
    src = cur.copy()
    for k in range(2, 25):
        prev, cur = cur, two_cos * cur - prev
        src += (1.0 / k) * cur

    # Vocal-tract filter: per-50ms overlap-add FFT shaping with moving formants,
    # all frames in one batched FFT. Frames hop by half a frame, so the even
    # frames tile the signal from 0 and the odd ones from half a frame.
    frame, hop = 800, 400
    starts = np.arange(0, max(0, n - frame), hop)
    out = np.zeros(n)
    if len(starts):
        freqs = np.fft.rfftfreq(frame, 1 / sr)[None, :]
        at = starts[:, None] / sr
        f1 = v["f1"] + v["f1_swing"] * np.sin(2 * np.pi * v["f1_rate"] * at + ph[2])
        f2 = v["f2"] + v["f2_swing"] * np.sin(2 * np.pi * v["f2_rate"] * at + ph[3])
        shape = (
            np.exp(-(((freqs - f1) / 250) ** 2))
            + 0.7 * np.exp(-(((freqs - f2) / 350) ** 2))
            + 0.3 * np.exp(-(((freqs - v["f3"]) / 500) ** 2))
            + 0.02
        )
        frames = src[starts[:, None] + np.arange(frame)[None, :]] * np.hanning(frame)[None, :]
        shaped = np.fft.irfft(np.fft.rfft(frames, axis=1) * shape, frame, axis=1)
        for first in (0, 1):
            tiles = shaped[first::2].reshape(-1)
            out[first * hop : first * hop + len(tiles)] += tiles

    peak = np.abs(out).max() or 1.0
    out += 0.02 * rng.standard_normal(n) * (np.abs(out) / peak)  # aspiration
    envelope = 0.55 + 0.45 * np.clip(np.sin(2 * np.pi * v["syllable_rate"] * t + ph[4]), -0.8, 1)
    x = out * envelope
    x = 0.85 * x / (np.abs(x).max() or 1.0)
    # int16 round-trip: gives the quantization noise floor real captures have.
    pcm = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    return (pcm.astype(np.float32) / 32768.0).astype(np.float32)

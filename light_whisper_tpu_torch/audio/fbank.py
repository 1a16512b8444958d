"""Kaldi-compatible 80-dim log-mel fbank (counterpart of ``audio/fbank.py``).

16 kHz, 25 ms frames / 10 ms shift, snip_edges, DC-offset removal,
pre-emphasis 0.97, povey window, 512-point FFT, power spectrum, 80 mel bins
from 20 Hz to Nyquist, natural log with a float-epsilon floor.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

SAMPLE_RATE = 16_000
FRAME_LENGTH = 400
FRAME_SHIFT = 160
PADDED_WINDOW = 512
NUM_BINS = 80
PREEMPH = 0.97
LOW_FREQ = 20.0
HIGH_FREQ = SAMPLE_RATE / 2.0
LOG_FLOOR = float(np.finfo(np.float32).eps)


def num_frames(num_samples: int) -> int:
    """snip_edges frame count: frames fully inside the signal."""
    if num_samples < FRAME_LENGTH:
        return 0
    return 1 + (num_samples - FRAME_LENGTH) // FRAME_SHIFT


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=None)
def kaldi_mel_matrix() -> np.ndarray:
    """[PADDED_WINDOW//2 + 1, NUM_BINS] triangular filters, kaldi semantics
    (the Nyquist bin carries no weight)."""
    num_fft_bins = PADDED_WINDOW // 2
    mel_low = _mel_scale(LOW_FREQ)
    mel_high = _mel_scale(HIGH_FREQ)
    mel_delta = (mel_high - mel_low) / (NUM_BINS + 1)
    fft_bin_width = SAMPLE_RATE / PADDED_WINDOW
    bin_mels = _mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))
    weights = np.zeros((num_fft_bins + 1, NUM_BINS), dtype=np.float64)
    for b in range(NUM_BINS):
        left = mel_low + b * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (bin_mels - left) / (center - left)
        down = (right - bin_mels) / (right - center)
        weights[:num_fft_bins, b] = np.clip(np.minimum(up, down), 0.0, None)
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def povey_window() -> np.ndarray:
    n = np.arange(FRAME_LENGTH, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (FRAME_LENGTH - 1))
    return np.power(hann, 0.85).astype(np.float32)


def fbank_frames(waveform: torch.Tensor, frames: int) -> torch.Tensor:
    """[frames, 80] log-mel fbank (f32) of a 1-D waveform in int16 scale (±32768).

    Computed in float64: at int16 scale the DC removal and the power spectrum
    lose f32 digits in quiet bins (up to ~1e-4 in the log against a float64
    oracle); the features are small, so the wider type costs little."""
    x = waveform.double().unfold(0, FRAME_LENGTH, FRAME_SHIFT)[:frames]  # [T, 400]
    # kaldi ExtractWindow order: dc offset -> pre-emphasis -> window
    x = x - torch.mean(x, dim=-1, keepdim=True)
    prev = torch.cat([x[:, :1], x[:, :-1]], dim=-1)
    x = x - PREEMPH * prev
    x = x * torch.as_tensor(povey_window(), device=x.device, dtype=x.dtype)
    x = torch.nn.functional.pad(x, (0, PADDED_WINDOW - FRAME_LENGTH))
    spec = torch.fft.rfft(x, n=PADDED_WINDOW, dim=-1)
    power = spec.real.square() + spec.imag.square()  # [T, 257]
    mel = power @ torch.as_tensor(kaldi_mel_matrix(), device=x.device, dtype=x.dtype)
    return torch.log(torch.clamp_min(mel, LOG_FLOOR)).float()


def fbank(waveform: torch.Tensor) -> torch.Tensor:
    """[frames, 80] fbank of a 16 kHz waveform in int16 scale."""
    frames = num_frames(int(waveform.shape[-1]))
    if frames == 0:
        return torch.zeros((0, NUM_BINS), dtype=torch.float32, device=waveform.device)
    return fbank_frames(waveform, frames)

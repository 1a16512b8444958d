"""Whisper-style 128-bin log-mel spectrogram (counterpart of ``audio/mel.py``).

hann(400) periodic window, hop 160, centred frames with reflect padding,
power spectrum, Slaney-scale / Slaney-normalised 128-mel filterbank, ``log10``
floored at 1e-10, clamp at ``max - 8`` and ``(x + 4) / 4``. Frames are cut
explicitly (``unfold``), not with ``torch.stft`` defaults; ``torch.fft.rfft``
takes the place of XLA's FFT.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
N_MELS = 128
FMIN = 0.0
FMAX = 8000.0


def _hertz_to_mel_slaney(freq) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    with np.errstate(divide="ignore"):
        mels = np.where(
            log_region,
            min_log_mel + np.log(np.maximum(freq, 1e-12) / min_log_hertz) / logstep,
            mels,
        )
    return mels


def _mel_to_hertz_slaney(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    return np.where(log_region, min_log_hertz * np.exp(logstep * (mels - min_log_mel)), freq)


@functools.lru_cache(maxsize=None)
def whisper_mel_matrix() -> np.ndarray:
    """[N_FFT//2+1, N_MELS] Slaney filterbank (librosa ``norm='slaney'``)."""
    fft_freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    mel_pts = np.linspace(
        _hertz_to_mel_slaney(FMIN), _hertz_to_mel_slaney(FMAX), N_MELS + 2
    )
    hz_pts = _mel_to_hertz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[None, :] - fft_freqs[:, None]
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : N_MELS + 2] - hz_pts[:N_MELS])
    weights *= enorm[None, :]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window() -> np.ndarray:
    """Periodic hann(400): ``np.hanning(N_FFT + 1)[:-1]``."""
    n = np.arange(N_FFT, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / N_FFT)).astype(np.float32)


def num_mel_frames(num_samples: int) -> int:
    """Frames produced for a waveform (centred frames, last frame dropped)."""
    return num_samples // HOP


def log_mel_with_max(waveform: torch.Tensor, frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalised log-mel [..., frames, 128] f32, clip max [...]) of waveforms
    ``[..., N]``, float32 in [-1, 1] or int16 (scaled by 1/32768 on the
    device). Each clip is clamped at its own max."""
    if waveform.dtype == torch.int16:
        waveform = waveform.float() * (1.0 / 32768.0)
    lead = waveform.shape[:-1]
    pad = N_FFT // 2
    x = torch.nn.functional.pad(waveform.float().reshape(-1, 1, waveform.shape[-1]), (pad, pad),
                                mode="reflect")[:, 0]
    framed = x.unfold(-1, N_FFT, HOP)[:, :frames]
    framed = framed * torch.as_tensor(hann_window(), device=x.device)
    spec = torch.fft.rfft(framed, n=N_FFT, dim=-1)
    power = spec.real.square() + spec.imag.square()  # [clips, frames, 201]
    mel = power @ torch.as_tensor(whisper_mel_matrix(), device=x.device)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    clip_max = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, clip_max - 8.0)
    return ((log_spec + 4.0) / 4.0).reshape(*lead, frames, N_MELS), clip_max.reshape(lead)


def log_mel(waveform) -> torch.Tensor:
    """[..., frames, 128] whisper-normalised log-mel of 16 kHz audio ``[..., N]``
    (all of it: ``N // 160`` frames)."""
    waveform = torch.as_tensor(waveform)
    frames = num_mel_frames(int(waveform.shape[-1]))
    if frames == 0:
        return torch.zeros((*waveform.shape[:-1], 0, N_MELS), dtype=torch.float32, device=waveform.device)
    return log_mel_with_max(waveform, frames)[0]


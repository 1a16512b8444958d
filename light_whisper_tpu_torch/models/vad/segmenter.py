"""Probability → speech-segment hysteresis post-processor.

The port's copy of ``light_whisper_tpu/models/vad/segmenter.py``.

Host-side and sequential by nature (a few thousand frames at most), so it
stays in numpy/Python, matching the reference pipeline's split: the neural
classifier runs on the accelerator, the cheap state machine on host
(``firered_vad.py:121-191``). Behavior parity is pinned by tests against the
reference's published corner cases.

Semantics: probabilities are smoothed with a trailing moving average
(cumulative mean during warm-up); a speech segment opens once
``min_speech`` consecutive speech frames are seen (retroactively from the
first of them) and closes once ``min_silence`` consecutive non-speech frames
follow; segments get padded by ``speech_pad_ms`` and overlapping padded
segments merge.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

SAMPLE_RATE = 16_000
FRAME_SHIFT_SAMPLES = 160


@dataclasses.dataclass(frozen=True)
class SegmenterOptions:
    threshold: float = 0.5
    smooth_window_frames: int = 5
    min_speech_duration_ms: int = 150
    min_silence_duration_ms: int = 300
    speech_pad_ms: int = 120


def smooth_probabilities(probs: np.ndarray, window: int) -> np.ndarray:
    """Trailing moving average; cumulative mean over the first ``window-1``."""
    probs = np.asarray(probs, dtype=np.float32).reshape(-1)
    window = max(1, int(window))
    if window == 1 or probs.size == 0:
        return probs
    kernel = np.full(window, 1.0 / window, dtype=np.float32)
    smoothed = np.convolve(probs, kernel, mode="full")[: probs.size]
    warmup = min(window - 1, probs.size)
    if warmup:
        cumulative = np.cumsum(probs[:warmup], dtype=np.float64)
        smoothed[:warmup] = (cumulative / np.arange(1, warmup + 1)).astype(np.float32)
    return smoothed


def speech_segments(
    probs: np.ndarray,
    audio_length_samples: int,
    options: SegmenterOptions = SegmenterOptions(),
) -> List[Dict[str, int]]:
    """Return ``[{"start": s, "end": e}]`` in samples, padded and merged."""
    probs = np.asarray(probs, dtype=np.float32).reshape(-1)
    if probs.size == 0:
        return []

    flags = smooth_probabilities(probs, options.smooth_window_frames) >= options.threshold
    min_speech = max(1, options.min_speech_duration_ms // 10)
    min_silence = max(1, options.min_silence_duration_ms // 10)
    pad = max(0, options.speech_pad_ms * SAMPLE_RATE // 1000)

    raw: List[tuple] = []
    run_start = None  # first frame of the current candidate speech run
    active_start = None  # first frame of the open segment, if any
    gap_start = None  # first frame of the current silence run inside a segment

    for frame, is_speech in enumerate(flags):
        if active_start is None:
            if is_speech:
                run_start = frame if run_start is None else run_start
                if frame - run_start + 1 >= min_speech:
                    active_start = run_start
                    gap_start = None
            else:
                run_start = None
        elif is_speech:
            gap_start = None
        elif gap_start is None:
            gap_start = frame
        elif frame - gap_start + 1 >= min_silence:
            raw.append((active_start, gap_start))
            active_start = None
            run_start = None
            gap_start = None

    if active_start is not None:
        raw.append((active_start, probs.size))

    merged: List[Dict[str, int]] = []
    for start_frame, end_frame in raw:
        start = max(0, start_frame * FRAME_SHIFT_SAMPLES - pad)
        end = min(audio_length_samples, end_frame * FRAME_SHIFT_SAMPLES + pad)
        if end <= start:
            continue
        if merged and start <= merged[-1]["end"]:
            merged[-1]["end"] = max(merged[-1]["end"], end)
        else:
            merged.append({"start": start, "end": end})
    return merged

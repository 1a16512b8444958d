"""Long-form audio: VAD-driven segmentation → (batched) ASR → joined text.

The port's copy of ``light_whisper_tpu/serving/longform.py``.

BASELINE config #3. The reference feeds whole recordings to one GGUF session
call (bounded by its 32k KV context and a 30-minute capture cap); for long
recordings this engine instead:

1. runs FireRedVAD over the full audio (one device pass — cheap),
2. groups speech segments into windows of at most ``max_window_seconds``,
   cutting only at segment boundaries (inner pauses inside a window are
   preserved, exactly like the short-utterance path trims only outer
   silence),
3. transcribes the windows as one batch (``transcribe_batch``) so decode
   cost amortizes across the whole recording,
4. joins the texts (ASCII boundaries get a space; CJK joins directly).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from light_whisper_tpu_torch.runtime import tracing

SAMPLE_RATE = 16_000
DEFAULT_MAX_WINDOW_SECONDS = 28.0
DEFAULT_PAD_SECONDS = 0.12


@dataclasses.dataclass
class LongFormResult:
    text: str
    language: str
    num_windows: int
    speech_seconds: float
    # Attribution the wire surfaces per request (vad_ms / inference_ms for
    # the short path; long-form reports its own split + window sizes so a
    # 30-min request's cost is inspectable per window).
    vad_ms: float = 0.0
    asr_ms: float = 0.0
    window_seconds: List[float] = dataclasses.field(default_factory=list)


def plan_windows(
    segments: Sequence[Dict[str, int]],
    audio_len: int,
    max_window_seconds: float = DEFAULT_MAX_WINDOW_SECONDS,
    pad_seconds: float = DEFAULT_PAD_SECONDS,
) -> List[Tuple[int, int]]:
    """Group VAD segments into transcription windows ≤ max_window_seconds.

    Consecutive segments merge while the span start→end stays under the
    budget; an oversized single segment is split at the budget boundary.
    """
    max_samples = int(max_window_seconds * SAMPLE_RATE)
    pad = int(pad_seconds * SAMPLE_RATE)

    windows: List[Tuple[int, int]] = []
    current: Tuple[int, int] | None = None
    for seg in segments:
        start, end = int(seg["start"]), int(seg["end"])
        if current is None:
            current = (start, end)
        elif end - current[0] <= max_samples:
            current = (current[0], end)
        else:
            windows.append(current)
            current = (start, end)
    if current is not None:
        windows.append(current)

    # Split any window that alone exceeds the budget. Edges created by the
    # split abut MID-SPEECH (end == next start): padding those would make
    # consecutive windows re-transcribe the same 2×pad of speech and
    # duplicate the boundary word in the joined text, so only true segment
    # edges (VAD silence on the other side) get the acoustic-context pad.
    bounded: List[Tuple[int, int, bool, bool]] = []  # start, end, pad_l, pad_r
    for start, end in windows:
        first = True
        while end - start > max_samples:
            bounded.append((start, start + max_samples, first, False))
            start += max_samples
            first = False
        bounded.append((start, end, first, True))

    return [
        (
            max(0, s - (pad if pad_l else 0)),
            min(audio_len, e + (pad if pad_r else 0)),
        )
        for s, e, pad_l, pad_r in bounded
        if e > s
    ]


def _join_texts(texts: Sequence[str]) -> str:
    """Join window texts: Latin-script boundaries get one space (including
    after sentence punctuation — 'today.' + 'Then' must not fuse), CJK
    joins directly on either side."""
    out = ""
    for text in texts:
        text = text.strip()
        if not text:
            continue
        if out and out[-1].isascii() and not out[-1].isspace() and text[0].isascii():
            out += " " + text
        else:
            out += text
    return out


def transcribe_long_form(
    model,
    vad,
    audio: np.ndarray,
    max_window_seconds: float = DEFAULT_MAX_WINDOW_SECONDS,
) -> LongFormResult:
    import time

    audio = np.asarray(audio, dtype=np.float32).reshape(-1)
    with tracing.span("vad") as vad_span:
        segments = vad.speech_timestamps(audio)
    vad_ms = vad_span.seconds * 1000
    if not segments:
        return LongFormResult(
            text="", language="unknown", num_windows=0, speech_seconds=0.0, vad_ms=vad_ms
        )

    windows = plan_windows(segments, len(audio), max_window_seconds)
    clips = [audio[s:e] for s, e in windows]
    speech_seconds = sum(len(c) for c in clips) / SAMPLE_RATE

    t0 = time.perf_counter()
    results = model.transcribe_batch(clips)
    asr_ms = (time.perf_counter() - t0) * 1000
    language = next(
        (r.language for r in results if r.language not in ("", "unknown")), "unknown"
    )
    return LongFormResult(
        text=_join_texts([r.text for r in results]),
        language=language,
        num_windows=len(windows),
        speech_seconds=speech_seconds,
        vad_ms=vad_ms,
        asr_ms=asr_ms,
        window_seconds=[round((e - s) / SAMPLE_RATE, 2) for s, e in windows],
    )

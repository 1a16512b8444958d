"""Streaming dictation sessions: rolling window, stable prefix, finalize reuse.

The port's copy of ``light_whisper_tpu/serving/streaming.py``, the engine
side of the app's interim loop and finalize (``interim.rs:21-236``,
``finalize.rs:313-345`` there):

- audio accumulates in a capped buffer (30 min hard cap);
- each tick transcribes the **last 12 s window** and splits the hypothesis
  into stable/tentative against the previous tick;
- the tick interval adapts between 140 and 460 ms: +42 ms when a tick costs
  ≥ 420 ms, −24 ms when it costs ≤ 180 ms;
- finalize reuses the last interim hypothesis when the recording fits the
  window and the uncovered tail is ≤ 250 ms; otherwise it transcribes the
  whole buffer.

Window starts are aligned down to a whole encoder chunk (1 s), so that while
the buffer still fits the window the audio tokens only grow at the end: the
layout ``IncrementalTranscriber``'s KV-prefix reuse relies on.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from light_whisper_tpu_torch.text.prefix import InterimSegments, StablePrefixTracker

SAMPLE_RATE = 16_000
MAX_BUFFER_SAMPLES = 30 * 60 * SAMPLE_RATE  # 30-minute hard cap
WINDOW_SECONDS = 12.0
MIN_FIRST_TICK_SECONDS = 0.2
FINALIZE_REUSE_TAIL_GAP_SECONDS = 0.25

# adaptive interval parameters (the app's audio_service/mod.rs:13-19)
INTERVAL_BASE_MS = 220
INTERVAL_MIN_MS = 140
INTERVAL_MAX_MS = 460
INTERVAL_STEP_UP_MS = 42
INTERVAL_STEP_DOWN_MS = 24
TICK_HEAVY_MS = 420
TICK_LIGHT_MS = 180


def adapt_interval(current_ms: int, tick_cost_ms: float) -> int:
    if tick_cost_ms >= TICK_HEAVY_MS:
        return min(INTERVAL_MAX_MS, current_ms + INTERVAL_STEP_UP_MS)
    if tick_cost_ms <= TICK_LIGHT_MS:
        return max(INTERVAL_MIN_MS, current_ms - INTERVAL_STEP_DOWN_MS)
    return current_ms


@dataclasses.dataclass
class InterimResult:
    text: str
    stable: str
    tentative: str
    covered_samples: int
    tick_ms: float


@dataclasses.dataclass
class FinalResult:
    text: str
    language: str
    from_interim_cache: bool


class StreamingSession:
    """One dictation recording: feed audio, tick for interim, finalize."""

    def __init__(
        self,
        transcriber,
        window_seconds: float = WINDOW_SECONDS,
        align_samples: int = SAMPLE_RATE,  # one encoder chunk (100 mel frames)
    ) -> None:
        self._transcriber = transcriber
        self._window_samples = int(window_seconds * SAMPLE_RATE)
        self._align = max(1, align_samples)
        # a list of chunks, not one growing array: concatenating a 30-minute
        # buffer on every pump is quadratic over a recording, and ticks read
        # only the last 12 s
        self._chunks: collections.deque = collections.deque()
        self._total = 0
        self._tracker = StablePrefixTracker()
        self._interval_ms = INTERVAL_BASE_MS
        self._last_hypothesis: Optional[str] = None
        self._last_language = "unknown"
        self._covered_samples = 0

    @property
    def buffered_samples(self) -> int:
        return self._total

    @property
    def next_interval_ms(self) -> int:
        return self._interval_ms

    def accept(self, samples: np.ndarray) -> None:
        samples = np.array(samples, dtype=np.float32).reshape(-1)  # owned copy
        if not len(samples):
            return
        self._chunks.append(samples)
        self._total += len(samples)
        # the cap slides: keep the newest 30 minutes
        while self._total - len(self._chunks[0]) >= MAX_BUFFER_SAMPLES:
            self._total -= len(self._chunks.popleft())
        if self._total > MAX_BUFFER_SAMPLES:
            excess = self._total - MAX_BUFFER_SAMPLES
            self._chunks[0] = self._chunks[0][excess:]
            self._total = MAX_BUFFER_SAMPLES

    def _materialize(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, dtype=np.float32)
        if len(self._chunks) == 1:
            return self._chunks[0]
        whole = np.concatenate(list(self._chunks))
        self._chunks = collections.deque([whole])  # later full reads stay O(1)
        return whole

    def _tail(self, n: int) -> np.ndarray:
        out = []
        got = 0
        for chunk in reversed(self._chunks):
            if got >= n:
                break
            need = n - got
            out.append(chunk if len(chunk) <= need else chunk[-need:])
            got += len(out[-1])
        out.reverse()
        if not out:
            return np.zeros(0, dtype=np.float32)
        return np.concatenate(out) if len(out) > 1 else out[0]

    def _window_with_start(self):
        """(the last ≤ 12 s window, its offset in the buffer); the start is
        aligned down to a whole encoder chunk."""
        n = self._total
        if n <= self._window_samples:
            return self._materialize(), 0
        start = n - self._window_samples
        start -= start % self._align
        return self._tail(n - start), start

    def tick(self) -> Optional[InterimResult]:
        if self._total < int(MIN_FIRST_TICK_SECONDS * SAMPLE_RATE):
            return None
        window, start = self._window_with_start()
        started = time.perf_counter()
        # a KV-reusing transcriber must know where the window starts: once
        # the buffer outgrows the window the start slides, and its cached
        # audio-token prefix describes other samples
        if hasattr(self._transcriber, "transcribe_window"):
            result = self._transcriber.transcribe_window(window, window_start_sample=start)
        else:
            result = self._transcriber.transcribe(window)
        tick_ms = (time.perf_counter() - started) * 1000

        self._interval_ms = adapt_interval(self._interval_ms, tick_ms)
        self._last_hypothesis = result.text
        self._last_language = getattr(result, "language", "unknown")
        self._covered_samples = self._total

        segments: InterimSegments = self._tracker.update(result.text)
        return InterimResult(
            text=result.text,
            stable=segments.stable,
            tentative=segments.tentative,
            covered_samples=self._covered_samples,
            tick_ms=tick_ms,
        )

    def finalize(self) -> FinalResult:
        n = self._total
        tail_gap = n - self._covered_samples
        fits_window = n <= self._window_samples
        if (
            self._last_hypothesis is not None
            and fits_window
            and tail_gap <= int(FINALIZE_REUSE_TAIL_GAP_SECONDS * SAMPLE_RATE)
        ):
            return FinalResult(
                text=self._last_hypothesis,
                language=self._last_language,
                from_interim_cache=True,
            )
        result = self._transcriber.transcribe(self._materialize())
        return FinalResult(
            text=result.text,
            language=getattr(result, "language", "unknown"),
            from_interim_cache=False,
        )

    def discard(self) -> None:
        self._chunks = collections.deque()
        self._total = 0
        self._tracker.reset()
        self._last_hypothesis = None
        self._covered_samples = 0

"""Protocol-level session reuse (counterpart of ``serving/session_bridge.py``).

The app drives its interim loop by re-sending the (VAD-trimmed) growing window
through plain ``transcribe`` commands. This bridge makes that cheap with no
protocol change:

- audio that **byte-exactly extends** the previous request's audio continues
  the incremental transcriber's KV prefix and verifies the previous transcript
  as a draft;
- any other audio resets the session: the result is that of a stateless
  ``transcribe`` with a fresh cache.

The prefix check is a memcmp over the overlap; VAD trim offsets that move
between ticks fail it and reset, so correctness never rests on VAD stability.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber
from light_whisper_tpu_torch.serving.incremental_batch import tick_batch

# Per-stream cap on the host audio parked for the next tick's prefix memcmp.
# Interim windows park far below it (12 s is 384 KB of int16); what it leaves
# out is a long one-shot request, which nothing extends. Audio over the cap is
# not parked: the next tick resets, which is the stateless behaviour.
DEFAULT_PARK_MAX_BYTES = 8 << 20


def park_max_bytes() -> int:
    try:
        return max(0, int(os.environ.get("LWT_SESSION_PARK_MAX_BYTES", DEFAULT_PARK_MAX_BYTES)))
    except ValueError:
        return DEFAULT_PARK_MAX_BYTES


def _parkable(audio: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if audio is None or audio.nbytes > park_max_bytes():
        return None
    return audio


class SessionBridge:
    def __init__(self, model) -> None:
        self.model = model
        self._inc = IncrementalTranscriber(model, max_new_tokens=model.max_new_tokens)
        self._prev: Optional[np.ndarray] = None
        self.session_hits = 0
        self.session_resets = 0

    def _extends_previous(self, audio: np.ndarray) -> bool:
        prev = self._prev
        return prev is not None and len(audio) >= len(prev) and np.array_equal(audio[: len(prev)], prev)

    def _start_tick(self, audio) -> np.ndarray:
        # dtype kept: the server hands int16 for exact-s16 audio
        audio = np.asarray(audio).reshape(-1)
        if self._extends_previous(audio):
            self.session_hits += 1
        else:
            self._inc.reset()
            self.session_resets += 1
        return audio

    def transcribe_extending(self, audio: np.ndarray):
        audio = self._start_tick(audio)
        result = self._inc.transcribe_window(audio, window_start_sample=0)
        self._prev = _parkable(audio)
        return result

    def reset(self) -> None:
        self._inc.reset()
        self._prev = None

    @property
    def retained_bytes(self) -> int:
        prev = self._prev
        return 0 if prev is None else int(prev.nbytes)


def transcribe_extending_batch(bridges, audios):
    """:meth:`SessionBridge.transcribe_extending` for N streams in one tick
    (``serving/incremental_batch.tick_batch``): each stream keeps its own
    extends-previous check and KV session; a failed stream's result is its
    exception, and it parks nothing."""
    windows = [bridge._start_tick(audio) for bridge, audio in zip(bridges, audios)]
    results = tick_batch([bridge._inc for bridge in bridges], windows)
    for bridge, window, result in zip(bridges, windows, results):
        # a failed tick reset its session: a parked window over it would let
        # diverging audio skip the reset and extend KV built from other audio
        bridge._prev = None if isinstance(result, BaseException) else _parkable(window)
    return results

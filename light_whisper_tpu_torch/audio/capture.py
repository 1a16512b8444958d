"""Host audio capture: downmix, capped ring buffer, waveform bars.

The port's copy of ``light_whisper_tpu/audio/capture.py``: the portable core
of the app's capture service. The OS device backends (WASAPI
voice-processing / cpal streams, ``capture.rs:310-430``,
``windows_capture.rs``) belong to the desktop shell and stay out of scope;
everything downstream of the device callback is engine-relevant behavior
and is rebuilt here:

- multi-channel I16/F32/U16 downmix to mono i16
  (``capture.rs:150-232`` ``mix_to_mono_capped_*``);
- the shared sample ring with the 30-minute hard cap
  (``capture.rs:18`` ``MAX_RECORD_SAMPLES``, append-capped so a stuck
  hotkey cannot grow memory unboundedly);
- the waveform RMS bars emitter — 9 bars every 55 ms over the newest
  audio (``capture.rs:236-289``), driving the recording overlay;
- a source abstraction standing in for the device stream: anything that
  pushes frames into a callback (tests/serving use :class:`ScriptedSource`
  to replay arrays with real thread + pacing semantics).

The ring stores mono i16 at the SOURCE sample rate — exactly the
reference's layout (capture appends device-rate i16; the interim loop and
finalize resample downstream, ``interim.rs:36-133`` / ``finalize.rs:782``).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, List, Optional, Protocol, Sequence

import numpy as np

# 30-minute hard cap, in samples at the ring's sample rate
# (capture.rs:18: MAX_RECORD_SAMPLES = 16_000 * 60 * 30 at its fixed 16 k).
MAX_RECORD_SECONDS = 30 * 60

WAVEFORM_BARS = 9
WAVEFORM_INTERVAL_MS = 55


def mix_to_mono(frames: np.ndarray, channels: int = 1) -> np.ndarray:
    """Downmix an interleaved or [n, ch] frame block to mono i16.

    Accepts the three device formats the reference converts
    (``mix_to_mono_capped_{i16,f32,u16}``, ``capture.rs:150-232``):
    i16 passthrough, f32 in [-1, 1], and u16 offset-binary. Channels are
    averaged; the result is clipped into i16 range.
    """
    a = np.asarray(frames)
    if a.ndim == 1 and channels > 1:
        n = (len(a) // channels) * channels
        a = a[:n].reshape(-1, channels)
    if a.dtype == np.int16:
        mono = a.astype(np.float32)
    elif a.dtype in (np.float32, np.float64):
        mono = np.clip(a.astype(np.float32), -1.0, 1.0) * 32767.0
    elif a.dtype == np.uint16:
        mono = a.astype(np.float32) - 32768.0
    else:
        raise TypeError(f"unsupported capture dtype: {a.dtype}")
    if mono.ndim == 2:
        mono = mono.mean(axis=1)
    return np.clip(np.rint(mono), -32768, 32767).astype(np.int16)


class CaptureRing:
    """Append-only shared sample buffer with the 30-minute hard cap.

    The reference shares ``Arc<Mutex<Vec<i16>>>`` between the capture
    thread, the interim loop, and finalize (``capture.rs:293-452``); this
    is the same contract: one writer appends, any reader snapshots, and
    appends beyond the cap are silently dropped (the recording simply
    stops growing, it does not fail).
    """

    def __init__(self, sample_rate: int = 16_000) -> None:
        self.sample_rate = int(sample_rate)
        self.max_samples = MAX_RECORD_SECONDS * self.sample_rate
        self._chunks: List[np.ndarray] = []
        self._starts: List[int] = []  # cumulative start offset per chunk
        self._total = 0
        self._lock = threading.Lock()

    def append(self, mono_i16: np.ndarray) -> int:
        """Append capped; returns how many samples were actually taken."""
        samples = np.asarray(mono_i16, dtype=np.int16).reshape(-1)
        with self._lock:
            room = self.max_samples - self._total
            if room <= 0:
                return 0
            # Own the data: device backends legitimately reuse their callback
            # buffer between blocks, and asarray on an i16 input is a view.
            take = np.array(samples[:room], dtype=np.int16)
            self._chunks.append(take)
            self._starts.append(self._total)
            self._total += len(take)
            return len(take)

    def __len__(self) -> int:
        with self._lock:
            return self._total

    def snapshot(self) -> np.ndarray:
        with self._lock:
            chunks = list(self._chunks)
        if not chunks:
            return np.zeros(0, dtype=np.int16)
        return np.concatenate(chunks)

    def delta_since(self, offset: int) -> np.ndarray:
        """Samples appended at/after ``offset`` (the interim loop's cursor).

        Copies only the tail past ``offset`` — the interim loop calls this
        every ~220 ms and a 30-minute ring is ~58 MB, so a full-snapshot
        slice here would turn each tick into a buffer-sized copy."""
        with self._lock:
            return self._tail_from(offset)

    def tail(self, n: int) -> np.ndarray:
        """The newest ``n`` samples (waveform emitter window) without
        materializing the whole ring."""
        with self._lock:
            return self._tail_from(max(0, self._total - n))

    def _tail_from(self, offset: int) -> np.ndarray:
        # caller holds self._lock. Bisect the cumulative start offsets to
        # the first relevant chunk: ~10 ms device callbacks accumulate
        # ~180k chunks over a capped recording, and a linear scan here runs
        # inside the lock on every interim tick AND every 55 ms waveform
        # emit, starving the capture thread's append late in a recording.
        offset = max(0, offset)
        if offset >= self._total:
            return np.zeros(0, dtype=np.int16)
        first = bisect.bisect_right(self._starts, offset) - 1
        pos = self._starts[first]
        out = [self._chunks[first][offset - pos :]]
        out.extend(self._chunks[first + 1 :])
        return np.concatenate(out) if len(out) > 1 else out[0].copy()


class CaptureSource(Protocol):
    """A device-stream stand-in: pushes frame blocks into a callback."""

    def start(self, on_frames: Callable[[np.ndarray], None]) -> None: ...

    def stop(self) -> None: ...


class ScriptedSource:
    """Replays pre-cut frame blocks on a real thread.

    ``realtime=True`` paces blocks at their audio duration (device-like
    timing for soak/latency tests); ``False`` floods them as fast as the
    consumer accepts (deterministic unit tests).
    """

    def __init__(
        self,
        blocks: Sequence[np.ndarray],
        sample_rate: int = 16_000,
        channels: int = 1,
        realtime: bool = False,
    ) -> None:
        self.blocks = [np.asarray(b) for b in blocks]
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.realtime = realtime
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self, on_frames: Callable[[np.ndarray], None]) -> None:
        if self._thread is not None:
            raise RuntimeError("source already started")
        self._stop.clear()

        def run() -> None:
            for block in self.blocks:
                if self._stop.is_set():
                    return
                on_frames(block)
                if self.realtime:
                    frames = len(block) // max(1, self.channels)
                    self._stop.wait(frames / self.sample_rate)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def drained(self) -> bool:
        t = self._thread
        return t is None or not t.is_alive()


class CaptureHandle:
    """A started capture: source frames → downmix → ring."""

    def __init__(self, source: CaptureSource, ring: CaptureRing):
        self.source = source
        self.ring = ring

    def stop(self) -> None:
        self.source.stop()


def start_capture(
    source: CaptureSource, ring: CaptureRing, channels: int = 1
) -> CaptureHandle:
    """Wire a source's frames through downmix into the ring and start it
    (the portable half of ``spawn_audio_capture_thread``,
    ``capture.rs:293-452``)."""
    handle = CaptureHandle(source, ring)
    source.start(lambda frames: ring.append(mix_to_mono(frames, channels)))
    return handle


def waveform_bars(samples_i16: np.ndarray, n_bars: int = WAVEFORM_BARS) -> List[float]:
    """RMS bars (0..1) over equal slices of ``samples_i16``.

    The per-emit shape the reference's waveform emitter computes
    (``capture.rs:236-289``: 9 bars per 55 ms emit). Empty/short input
    yields zero bars — the overlay renders a flat line while audio ramps.
    """
    x = np.asarray(samples_i16, dtype=np.float32) / 32768.0
    bars = [0.0] * n_bars
    if len(x) == 0:
        return bars
    parts = np.array_split(x, n_bars)
    for i, p in enumerate(parts):
        if len(p):
            bars[i] = float(np.sqrt(np.mean(p * p)))
    return bars


class WaveformEmitter:
    """Emits RMS bars every ``interval_ms`` over the newest ring audio."""

    def __init__(
        self,
        ring: CaptureRing,
        callback: Callable[[List[float]], None],
        n_bars: int = WAVEFORM_BARS,
        interval_ms: int = WAVEFORM_INTERVAL_MS,
    ) -> None:
        self.ring = ring
        self.callback = callback
        self.n_bars = n_bars
        self.interval_ms = interval_ms
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # each emit covers the newest n_bars * interval of audio
        self._window = int(ring.sample_rate * n_bars * interval_ms / 1000)

    def start(self) -> None:
        def run() -> None:
            while not self._stop.wait(self.interval_ms / 1000):
                self.callback(waveform_bars(self.ring.tail(self._window), self.n_bars))

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

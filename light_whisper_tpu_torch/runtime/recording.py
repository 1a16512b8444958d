"""Recording lifecycle orchestration: start / stop / cancel a dictation.

The port's copy of ``light_whisper_tpu/runtime/recording.py``. Portable core of the reference's recording commands
(``audio.rs:77-345`` ``start_recording_inner``, ``:347-438``
``stop_recording_inner``, ``finalize.rs:175-780``), composed from the
engine-side pieces this package already ships:

- :class:`~light_whisper_tpu_torch.audio.capture.CaptureRing` +
  ``start_capture`` — the device-thread → shared-ring half;
- :class:`~light_whisper_tpu_torch.serving.streaming.StreamingSession` — the
  interim loop body (12 s rolling window, adaptive 140-460 ms tick,
  stable/tentative prefix split, finalize-from-interim-cache reuse);
- :class:`~light_whisper_tpu_torch.runtime.recording_state.RecordingSessionState`
  — the phase machine with session-gated transitions, so a stale
  finalize can never clobber a newer recording (``app_state.rs:24-370``).

What stays with the shell: window show/hide, paste, hotkeys, tones. The
controller exposes the same decision points as the reference commands —
session-ID allocation, Starting→Recording promotion (aborted if a newer
session superseded it mid-start), stop joining capture + interim before
finalize (``finalize.rs:191-207``), the <0.5 s too-short gate
(``finalize.rs:267-279``), and discard (``finalize.rs:758-780``).

On a GPU the interim thread launches its kernels on the current stream of
its own thread, the default stream, as finalize does on the caller's: the
two are ordered by ``session_lock`` and the join, never by a stream. The
kernels' launch counters are plain dicts that the interim thread bumps; read
them after ``stop_recording`` returns.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from light_whisper_tpu_torch.audio.capture import (
    CaptureHandle,
    CaptureRing,
    CaptureSource,
    WaveformEmitter,
    start_capture,
)
from light_whisper_tpu_torch.audio.pcm import StreamingResampler
from light_whisper_tpu_torch.runtime.recording_state import (
    RecordingOutcomeKind,
    RecordingPhase,
    RecordingSessionState,
)
from light_whisper_tpu_torch.serving.streaming import (
    SAMPLE_RATE,
    InterimResult,
    StreamingSession,
)

log = logging.getLogger(__name__)

MIN_RECORD_SECONDS = 0.5  # finalize.rs:267-279: shorter recordings → too_short
INTERIM_JOIN_TIMEOUT_S = 5.0  # finalize.rs:191-207: bounded interim join


@dataclasses.dataclass
class RecordingResult:
    session_id: int
    text: str
    language: str
    duration_seconds: float
    too_short: bool
    from_interim_cache: bool
    asr_ms: float
    interim_ticks: int


class _Active:
    def __init__(
        self,
        session_id: int,
        mode: str,
        ring: CaptureRing,
        handle: CaptureHandle,
        session: StreamingSession,
    ) -> None:
        self.session_id = session_id
        self.mode = mode
        self.ring = ring
        self.handle = handle
        self.session = session
        self.stop_event = threading.Event()
        # Serializes session access between the interim thread and
        # stop/cancel. The reference aborts its interim task after the 5 s
        # join budget (tokio abort, finalize.rs:191-207); a Python thread
        # cannot be aborted, so a timed-out join instead falls through to
        # this lock — finalize waits for the in-flight tick rather than
        # racing it (a tick rolls the KV cache's position back and writes the
        # cache in place; a concurrent finalize would read a half-written one).
        self.session_lock = threading.Lock()
        self.interim_thread: Optional[threading.Thread] = None
        self.waveform: Optional[WaveformEmitter] = None
        self.consumed = 0  # ring cursor (source-rate samples)
        self.ticks = 0
        self.tick_errors = 0
        # Phase-continuous across deltas: per-chunk resampling would restart
        # the sample grid at every pump (seam artifacts ~4.5×/s at 48 kHz).
        self.resampler = StreamingResampler(ring.sample_rate, SAMPLE_RATE)


class RecordingController:
    """One recording at a time: the reference's single-slot semantics
    (``app_state.rs`` holds one recording slot; a second start while one
    is active is rejected by the commands layer)."""

    def __init__(
        self,
        transcriber,
        state: Optional[RecordingSessionState] = None,
    ) -> None:
        self.transcriber = transcriber
        self.state = state or RecordingSessionState()
        self._lock = threading.Lock()
        self._active: Optional[_Active] = None

    # -- commands ------------------------------------------------------

    def start_recording(
        self,
        source: CaptureSource,
        *,
        channels: int = 1,
        sample_rate: int = SAMPLE_RATE,
        mode: str = "dictation",
        on_interim: Optional[Callable[[InterimResult], None]] = None,
        on_waveform: Optional[Callable[[List[float]], None]] = None,
        interval_scale: float = 1.0,
    ) -> int:
        """Allocate a session, spawn capture + interim loop, promote
        Starting→Recording. Returns the session id."""
        with self._lock:
            if self._active is not None:
                raise RuntimeError("a recording is already active")
            session_id = self.state.begin_session(mode)
            ring = CaptureRing(sample_rate)
            try:
                handle = start_capture(source, ring, channels)
            except Exception as exc:
                self.state.transition_if_current(
                    session_id,
                    RecordingPhase.OUTCOME,
                    mode,
                    outcome=RecordingOutcomeKind.START_ERROR,
                    detail=str(exc),
                )
                raise
            active = _Active(
                session_id, mode, ring, handle, StreamingSession(self.transcriber)
            )

            def interim_loop() -> None:
                while not active.stop_event.wait(
                    active.session.next_interval_ms * interval_scale / 1000
                ):
                    # One bad tick (engine restarting, a UI callback raising)
                    # must not kill the loop for the rest of the recording —
                    # interim subtitles would freeze and finalize would pay
                    # one giant unpumped transcribe.
                    try:
                        with active.session_lock:
                            if active.stop_event.is_set():
                                return
                            self._pump(active)
                            result = active.session.tick()
                        if result is not None:
                            active.ticks += 1
                            if on_interim is not None:
                                on_interim(result)
                    except Exception:
                        active.tick_errors += 1
                        log.warning(
                            "interim tick failed (session %d)",
                            session_id,
                            exc_info=True,
                        )

            # Assign the threads/emitter BEFORE publishing _active: a
            # stop/cancel racing in right after the lock releases must find
            # them in _teardown (their stop events are pre-armed, so a
            # start() after teardown exits on the first wait).
            active.interim_thread = threading.Thread(target=interim_loop, daemon=True)
            if on_waveform is not None:
                active.waveform = WaveformEmitter(ring, on_waveform)
            self._active = active

        active.interim_thread.start()
        if active.waveform is not None:
            active.waveform.start()

        # Starting→Recording promotion; a newer session racing in between
        # makes this a no-op and the start unwinds (audio.rs:290-312).
        if (
            self.state.transition_if_current(
                session_id, RecordingPhase.RECORDING, mode
            )
            is None
        ):
            self._teardown(active)
            with self._lock:
                if self._active is active:
                    self._active = None
            raise RuntimeError("recording superseded during start")
        return session_id

    def stop_recording(self) -> RecordingResult:
        """Stop capture, join the interim loop, finalize (reusing the last
        interim hypothesis when it covers the recording)."""
        with self._lock:
            active = self._active
            self._active = None
        if active is None:
            raise RuntimeError("no active recording")

        sid, mode = active.session_id, active.mode
        self._teardown(active)
        self.state.transition_if_current(sid, RecordingPhase.PROCESSING, mode)

        # The join above is bounded; if a long tick outlived it, the lock
        # makes us wait for it here instead of using the session mid-tick.
        with active.session_lock:
            # drain whatever capture appended after the last tick
            self._pump(active)
            duration = len(active.ring) / active.ring.sample_rate
            if duration < MIN_RECORD_SECONDS:
                self.state.transition_if_current(
                    sid,
                    RecordingPhase.OUTCOME,
                    mode,
                    outcome=RecordingOutcomeKind.TOO_SHORT,
                )
                return RecordingResult(
                    sid, "", "unknown", duration, True, False, 0.0, active.ticks
                )

            started = time.perf_counter()
            try:
                final = active.session.finalize()
            except Exception as exc:
                self.state.transition_if_current(
                    sid,
                    RecordingPhase.OUTCOME,
                    mode,
                    outcome=RecordingOutcomeKind.ASR_ERROR,
                    detail=str(exc),
                )
                raise
        asr_ms = (time.perf_counter() - started) * 1000
        # success leaves no outcome snapshot: the shell pastes and the
        # state returns to idle (app_state clear after paste)
        self.state.clear_if_session(sid)
        return RecordingResult(
            sid,
            final.text,
            final.language,
            duration,
            False,
            final.from_interim_cache,
            asr_ms,
            active.ticks,
        )

    def cancel_recording(self) -> None:
        """Discard without transcribing (``discard_recording``,
        ``finalize.rs:758-780``)."""
        with self._lock:
            active = self._active
            self._active = None
        if active is None:
            return
        self._teardown(active)
        with active.session_lock:
            active.session.discard()
        self.state.clear_if_session(active.session_id)

    # -- internals -----------------------------------------------------

    def _pump(self, active: _Active) -> None:
        """Move new ring samples (source rate, i16) into the streaming
        session (16 k float32). Only new samples pay resample work, and the
        resampler carries its phase across deltas so the output grid is the
        one the whole recording would get (``interim.rs:36-133`` incremental
        cache + ``resample.rs:130-159`` stateful resampler)."""
        delta = active.ring.delta_since(active.consumed)
        if len(delta) == 0:
            return
        active.consumed += len(delta)
        f32 = active.resampler.push(delta.astype(np.float32) / 32768.0)
        if len(f32):
            active.session.accept(f32)

    def _teardown(self, active: _Active) -> None:
        active.stop_event.set()
        active.handle.stop()
        if active.waveform is not None:
            active.waveform.stop()
        thread = active.interim_thread
        # ident is None when a racing start hasn't called start() yet; its
        # loop exits on the first wait since stop_event is already set.
        if thread is not None and thread.ident is not None:
            thread.join(timeout=INTERIM_JOIN_TIMEOUT_S)

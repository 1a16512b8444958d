"""Recording-session snapshot state: phases, revisions, stale rejection.

The port's copy of ``light_whisper_tpu/runtime/recording_state.py``, itself
a port of the app's presentation state machine (``app_state.rs:24-370``):
every recording session moves through
``idle → starting → recording → processing → outcome`` and every transition
mints a monotonically increasing ``revision``. Consumers (subtitle overlay,
status UI, tests) render the snapshot with the highest revision; a finalize
task that lost a race to a newer session simply fails its transition instead
of clobbering the newer session's display.

The invariants that matter (and are tested):

- transitions for a session other than the CURRENT one return ``None``
  (``transition_snapshot_if_current`` guard, ``app_state.rs:325-328``);
- revisions are strictly increasing across all sessions — a consumer can
  always order two snapshots;
- terminal outcomes (``outcome`` phase) carry an outcome kind + optional
  detail; non-terminal phases never do;
- clearing is session-gated: a stale task can't blank a newer session's
  snapshot (``clear_snapshot_if_session``, ``app_state.rs:352-369``).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Optional


class RecordingPhase(enum.Enum):
    IDLE = "idle"
    STARTING = "starting"
    RECORDING = "recording"
    PROCESSING = "processing"
    OUTCOME = "outcome"


class RecordingOutcomeKind(enum.Enum):
    TOO_SHORT = "too_short"
    NO_SPEECH = "no_speech"
    ASR_ERROR = "asr_error"
    PROCESSING_ERROR = "processing_error"
    START_ERROR = "start_error"


@dataclasses.dataclass(frozen=True)
class RecordingSnapshot:
    session_id: int
    revision: int
    phase: RecordingPhase
    mode: str  # "dictation" | "assistant"
    outcome: Optional[RecordingOutcomeKind] = None
    detail: Optional[str] = None

    def to_event(self) -> dict:
        payload = {
            "sessionId": self.session_id,
            "revision": self.revision,
            "phase": self.phase.value,
            "mode": self.mode,
        }
        if self.outcome is not None:
            payload["outcome"] = self.outcome.value
        if self.detail is not None:
            payload["detail"] = self.detail
        return payload


class RecordingSessionState:
    """Current-session tracking + revisioned presentation snapshots."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._session_counter = 0
        self._revision = 0
        self._snapshot: Optional[RecordingSnapshot] = None

    # -- session lifecycle --------------------------------------------------

    def begin_session(self, mode: str = "dictation") -> int:
        """Start a new session; returns its id. The previous session's tasks
        become stale: their transitions and clears will be rejected."""
        with self._lock:
            self._session_counter += 1
            sid = self._session_counter
            self._revision += 1
            self._snapshot = RecordingSnapshot(
                sid, self._revision, RecordingPhase.STARTING, mode
            )
            return sid

    @property
    def current_session(self) -> int:
        with self._lock:
            return self._session_counter

    def snapshot(self) -> Optional[RecordingSnapshot]:
        with self._lock:
            return self._snapshot

    # -- transitions --------------------------------------------------------

    def transition_if_current(
        self,
        session_id: int,
        phase: RecordingPhase,
        mode: str,
        outcome: Optional[RecordingOutcomeKind] = None,
        detail: Optional[str] = None,
    ) -> Optional[RecordingSnapshot]:
        """Mint a new revision for ``session_id`` — or None if it's stale."""
        with self._lock:
            if self._session_counter != session_id:
                return None
            self._revision += 1
            if outcome is not None and phase == RecordingPhase.OUTCOME:
                snap = RecordingSnapshot(
                    session_id, self._revision, phase, mode, outcome, detail
                )
            else:
                snap = RecordingSnapshot(session_id, self._revision, phase, mode)
            self._snapshot = snap
            return snap

    def clear_if_session(self, session_id: int) -> bool:
        """Blank the snapshot iff it still belongs to ``session_id``."""
        with self._lock:
            if self._snapshot is not None and self._snapshot.session_id == session_id:
                self._snapshot = None
                return True
            return False

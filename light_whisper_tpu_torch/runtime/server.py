"""Line-delimited JSON engine server.

The port's copy of ``light_whisper_tpu/runtime/server.py``.

External contract (kept wire-compatible with the reference engine so the
Tauri/Rust shell can drive this engine unmodified — see
``src-tauri/resources/server_common.py:339-437`` of the reference app and the Rust
client ``funasr_service.rs:1353-1440``):

- One JSON object per line on stdin; one JSON object per line on stdout.
- Supported ``action`` values: ``transcribe`` / ``status`` / ``stats`` /
  ``cleanup`` / ``exit``.
- Every response echoes the integer ``request_id`` of its command when one was
  provided; responses to unparseable lines carry no ``request_id`` (the client
  falls back to its legacy correlation path).
- The very first line printed is the initialization result
  (``{"success": bool, ...}``), emitted before the dispatch loop starts.
- ``success: false`` responses carry ``error`` and usually a machine-readable
  ``type`` (``models_not_downloaded`` / ``import_error`` / ``init_error`` /
  ``transcription_error``) that the UI routes on.

Unlike the reference's inheritance design, the engine logic is injected as a
``ServerHooks`` value object so that protocol behavior can be tested with fakes
and in-memory pipes (the pattern the reference applies on the Rust side,
``funasr_service.rs:1978-2072``).

Pipelining: the reference engine handles one command at a time, serialized
behind the Rust client's process mutex. Because that client correlates
responses strictly by ``request_id`` (``funasr_service.rs:1394-1440``), this
server can do better without breaking the contract: ``transcribe`` commands
that carry a ``request_id`` are handed to worker threads so (a) reads never
block behind an in-flight transcription (``status``/``stats`` answer
immediately) and (b) concurrent transcribes reaching the engine hook can
coalesce into ONE batched decode on the device.
Commands without a ``request_id`` cannot be correlated out of order, so the
loop drains all in-flight work first and answers them in arrival order —
byte-identical behavior for a legacy serial client.

A pipelined transcribe records three spans here (``runtime/tracing.py``):
``wire.parse`` (its line read → parsed and handed to the pool),
``wire.pool_wait`` (handed → a worker starts it) and ``wire.reply`` (its
reply serialized, written and flushed). The worker serves it under its
request id (``tracing.requests``), which the spans beneath carry.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, IO, Optional

from light_whisper_tpu_torch.runtime import tracing


# The reference schedules a GC/cache cleanup every N transcriptions
# (server_common.py:202, CLEANUP_EVERY_N).
CLEANUP_EVERY_N = 20


@dataclasses.dataclass
class ServerHooks:
    """Engine callbacks driven by the dispatch loop.

    Every hook returns a JSON-serializable dict that is written back verbatim
    (plus the echoed ``request_id``).
    """

    initialize: Callable[[], Dict[str, Any]]
    transcribe: Callable[..., Dict[str, Any]]
    status: Callable[[], Dict[str, Any]]
    stats: Callable[[], Dict[str, Any]]
    cleanup: Callable[[], None] = lambda: None
    shutdown: Callable[[], None] = lambda: None


class EngineServer:
    """Dispatch loop speaking the Light-Whisper engine protocol."""

    def __init__(
        self,
        hooks: ServerHooks,
        *,
        stdin: Optional[IO[str]] = None,
        stdout: Optional[IO[str]] = None,
        logger: Optional[logging.Logger] = None,
        max_concurrency: Optional[int] = None,
    ) -> None:
        self._hooks = hooks
        self._stdin = stdin if stdin is not None else sys.stdin
        self._stdout = stdout if stdout is not None else sys.stdout
        self._log = logger or logging.getLogger(__name__)
        self._running = True
        if max_concurrency is None:
            # malformed values fall back to the default rather than killing
            # the engine before the init line (same policy as the other env
            # knobs, e.g. model.max_decode_batch)
            try:
                max_concurrency = int(
                    os.environ.get("LIGHT_WHISPER_MAX_CONCURRENCY", "8")
                )
            except ValueError:
                max_concurrency = 8
        self._max_concurrency = max(1, max_concurrency)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._emit_lock = threading.Lock()
        self._inflight = 0
        self._inflight_cv = threading.Condition()

    # ------------------------------------------------------------------

    def stop(self) -> None:
        self._running = False

    def _emit(self, payload: Dict[str, Any], request_id: Optional[int]) -> None:
        if request_id is not None and isinstance(payload, dict):
            payload = dict(payload)
            payload["request_id"] = request_id
        line = json.dumps(payload, ensure_ascii=False) + "\n"
        with self._emit_lock:
            try:
                self._stdout.write(line)
                self._stdout.flush()
            except (OSError, ValueError):
                # The reader end is gone (parent process died / pipe closed).
                # Nothing we write can ever be seen again, so treat it like
                # stdin EOF: stop the serve loop so the shutdown hook runs,
                # instead of letting EPIPE kill the emitting thread with the
                # scheduler/sessions abandoned mid-job. (ValueError is what a
                # closed text stream raises; BrokenPipeError ⊂ OSError.)
                self._running = False

    # -- pipelined transcribe plumbing ---------------------------------

    def _spawn_transcribe(self, command: Dict[str, Any], request_id: int) -> None:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self._max_concurrency,
                thread_name_prefix="lwt-transcribe",
            )
        with self._inflight_cv:
            self._inflight += 1
        self._executor.submit(self._run_transcribe, command, request_id, time.perf_counter())

    def _run_transcribe(self, command: Dict[str, Any], request_id: int, submitted: float) -> None:
        tracing.record("wire.pool_wait", time.perf_counter() - submitted)
        try:
            with tracing.requests((request_id,)):
                try:
                    result = self._dispatch("transcribe", command)
                except Exception as exc:
                    result = {
                        "success": False,
                        "error": str(exc),
                        "traceback": traceback.format_exc(),
                    }
                with tracing.span("wire.reply"):
                    self._emit(result, request_id)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def _drain(self) -> None:
        """Block until every pipelined transcribe has emitted its response."""
        with self._inflight_cv:
            while self._inflight > 0:
                self._inflight_cv.wait()

    # ------------------------------------------------------------------

    def run(self) -> None:
        """Emit the init result, then serve commands until EOF or ``exit``."""
        init_result = self._guard(self._hooks.initialize)
        self._emit(init_result, request_id=None)

        shutdown_ran = False
        while self._running:
            line = self._stdin.readline()
            read = time.perf_counter()
            if not line:
                break
            line = line.strip()
            if not line:
                continue

            try:
                command = json.loads(line)
            except json.JSONDecodeError:
                # No request_id can be recovered from a line that failed to
                # parse; the client treats this as a legacy-protocol response.
                self._emit({"success": False, "error": "无效的JSON命令"}, None)
                continue

            request_id: Optional[int] = None
            if isinstance(command, dict):
                rid = command.get("request_id")
                if isinstance(rid, int) and not isinstance(rid, bool):
                    request_id = rid

            action = command.get("action") if isinstance(command, dict) else None
            if request_id is None:
                # Legacy correlation is strictly ordered — let pipelined work
                # flush before answering so this response arrives in sequence.
                self._drain()
            try:
                if action == "exit":
                    self._drain()
                    self._emit({"success": True, "message": "服务器退出"}, request_id)
                    # exit is ACKNOWLEDGED: a shutdown-hook failure must not
                    # emit a duplicate request_id response or resurrect the
                    # serve loop (the client may already be force-killing us)
                    try:
                        self._hooks.shutdown()
                    except Exception:
                        self._log.warning("shutdown hook failed", exc_info=True)
                    shutdown_ran = True
                    break
                if action == "transcribe" and request_id is not None:
                    self._spawn_transcribe(command, request_id)
                    tracing.record("wire.parse", time.perf_counter() - read)
                    continue
                result = self._dispatch(action, command)
            except Exception as exc:  # pragma: no cover - defensive parity path
                result = {
                    "success": False,
                    "error": str(exc),
                    "traceback": traceback.format_exc(),
                }
            self._emit(result, request_id)
        self._drain()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        # EOF (parent died / stdin closed) is the most common real-world
        # termination — run the same shutdown hook the exit command gets so
        # the scheduler/sessions aren't abandoned mid-job.
        if not shutdown_ran:
            try:
                self._hooks.shutdown()
            except Exception:
                self._log.warning("shutdown hook failed at EOF", exc_info=True)

    # ------------------------------------------------------------------

    def _dispatch(self, action: Any, command: Dict[str, Any]) -> Dict[str, Any]:
        if action == "transcribe":
            return self._hooks.transcribe(
                audio_path=command.get("audio_path"),
                options=command.get("options", {}),
                hot_words=command.get("hot_words"),
                audio_base64=command.get("audio_base64"),
                audio_format=command.get("audio_format"),
                sample_rate=command.get("sample_rate"),
            )
        if action == "status":
            return self._hooks.status()
        if action == "stats":
            return {"success": True, "stats": self._hooks.stats()}
        if action == "cleanup":
            self._hooks.cleanup()
            return {"success": True, "message": "内存清理完成"}
        return {"success": False, "error": f"未知命令: {action}"}

    @staticmethod
    def _guard(fn: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
        try:
            return fn()
        except Exception as exc:
            return {
                "success": False,
                "error": str(exc),
                "traceback": traceback.format_exc(),
            }

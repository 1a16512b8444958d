"""Qwen3-ASR engine server on PyTorch (counterpart of ``runtime/qwen3_server.py``).

Response-shape parity with the reference server: duration floor, VAD-gated
empty results, outer-silence trimming that keeps inner pauses, per-request
``vad_ms`` / ``inference_ms``, cumulative stats, and typed init errors
(``models_not_downloaded`` / ``import_error`` / ``init_error``) the UI routes
on. Replies keep the reference's fields one for one; ``backend`` reports
``cuda`` (or ``cpu`` when run on the CPU on purpose).

The app's interim loop re-sends one growing recording every 140-460 ms; the
server serves those ticks through per-stream KV sessions, as the reference
does:

- ``_transcribe_model`` routes a request through its stream's
  ``SessionBridge`` (``serving/session_pool.py``, keyed by ``options.stream``
  or ``DEFAULT_STREAM``): audio that extends the stream's previous request
  rolls the KV cache back to the stable prefix and verifies the previous
  transcript as a draft (``serving/incremental.py``); other audio resets;
- ``_vad_timestamps`` keeps a ``VadPrefixSession`` a stream (an LRU of twice
  the session limit) that recomputes only the new tail of a growing buffer;
- ``_stabilize_trim`` pins the leading VAD trim across ticks whose raw audio
  extends the previous one, within ``TRIM_PIN_TOLERANCE_SAMPLES``, so the
  trimmed bytes stay a prefix and the session keeps extending;
- coalesced requests (``_submit_decode`` → ``_run_decode_batch``) of distinct
  sessions run one batched tick (``serving/incremental_batch.tick_batch``,
  ``LWT_BATCH_TICKS``); duplicate keys take ``model.transcribe_batch``.

``LIGHT_WHISPER_DISABLE_SESSION_REUSE`` (read on every call) serves every
request stateless. Long recordings take ``_transcribe_long_form``
(``serving/longform.py``: VAD over the whole recording, windows, one batched
decode). The reference's warm-up ladder precompiles XLA programs and is not
ported.

A request's audio decode and its VAD are the ``wire.audio`` and ``vad``
spans (``runtime/tracing.py``); ``stats`` reports every span of the engine
as ``spans``.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from light_whisper_tpu_torch import __version__
from light_whisper_tpu_torch.audio.pcm import decode_inline_audio, read_audio_file_mono_f32, resample_linear
from light_whisper_tpu_torch.download.cache import QWEN3_ASR_MODELS, find_snapshot_file
from light_whisper_tpu_torch.models.qwen3_asr.model import as_device_audio, resolve_device
from light_whisper_tpu_torch.models.vad.api import VadPrefixSession
from light_whisper_tpu_torch.runtime import tracing
from light_whisper_tpu_torch.runtime.server import CLEANUP_EVERY_N, EngineServer, ServerHooks
from light_whisper_tpu_torch.serving import incremental_batch
from light_whisper_tpu_torch.serving.session_bridge import transcribe_extending_batch
from light_whisper_tpu_torch.serving.session_pool import DEFAULT_STREAM, SessionPool, max_sessions

SAMPLE_RATE = 16_000
MIN_DURATION_SECONDS = 0.5
# Above this, transcription goes through the VAD-segmented long-form path
# (windows batched on the device) instead of one context. A request forces
# either way with options={"long_form": bool}.
LONG_FORM_THRESHOLD_SECONDS = 120.0
# When a request's raw audio byte-extends the previous one on its stream, a
# leading trim within this many samples (150 ms) of the previous one is pinned
# to it, so that session reuse survives VAD jitter.
TRIM_PIN_TOLERANCE_SAMPLES = 2400
# Pins only matter for the interim loop's window (12 s and some padding);
# longer audio re-trims fresh (the stateless behaviour) and is not retained.
TRIM_PIN_MAX_SAMPLES = 30 * SAMPLE_RATE
# Byte budget across all trim pins (their count follows LWT_MAX_SESSIONS).
DEFAULT_TRIM_PIN_MAX_BYTES = 16 << 20


def _trim_pin_budget_bytes() -> int:
    try:
        return max(0, int(os.environ.get("LWT_TRIM_PIN_MAX_BYTES", DEFAULT_TRIM_PIN_MAX_BYTES)))
    except ValueError:
        return DEFAULT_TRIM_PIN_MAX_BYTES


def _session_reuse_disabled() -> bool:
    return bool(os.environ.get("LIGHT_WHISPER_DISABLE_SESSION_REUSE"))


class Qwen3EngineServer:
    """Engine logic on ``device``; plug into :class:`EngineServer` via :meth:`hooks`."""

    def __init__(
        self,
        engine: Optional[str] = None,
        device="cuda",
        model_factory: Optional[Callable[[str], Any]] = None,
        vad_factory: Optional[Callable[[], Any]] = None,
        model_path: Optional[str] = None,
        apply_hot_words: bool = True,
        logger: Optional[logging.Logger] = None,
    ) -> None:
        self.device = resolve_device(device)  # raises for cuda without a GPU
        engine = engine or os.environ.get("LIGHT_WHISPER_ASR_ENGINE", "qwen3-asr-0.6b")
        if engine not in QWEN3_ASR_MODELS:
            raise ValueError(f"不支持的 Qwen3-ASR 引擎: {engine}")
        self.engine = engine
        self.model_config = QWEN3_ASR_MODELS[engine]
        self.backend = self.device.type
        self.log = logger or logging.getLogger(__name__)
        self._model_factory = model_factory or self._default_model
        self._vad_factory = vad_factory or self._default_vad
        self._explicit_model_path = model_path
        self._apply_hot_words = apply_hot_words

        self.model = None
        self.vad = None
        self._session_pool = None  # per-stream KV sessions; False when the model has none
        self._scheduler = None  # device serialization + batch coalescing
        self._init_timings: Dict[str, float] = {}  # per-phase init walls
        self._stats_lock = threading.Lock()
        self._init_lock = threading.Lock()  # pipelined requests may race init
        self._anon_stream = itertools.count()
        self.initialized = False
        self.transcription_count = 0
        self.total_audio_duration = 0.0
        self._total_inference_ms = 0.0
        self._total_vad_ms = 0.0
        self._vad_calls = 0
        self._vad_rejected = 0
        self._batched_requests = 0
        self._batch_dispatches = 0
        self._batched_tick_dispatches = 0  # coalesced ticks that kept their sessions
        # per session key: (raw audio, start, end) of its last request's trim
        self._prev_trims: Dict[str, Any] = {}
        # per session key: incremental VAD over the growing buffer
        self._vad_sessions: Dict[str, Any] = {}
        self._vad_prefix_reuse = 0
        self._last_load_error: Optional[str] = None
        self._hotword_corrector = None

    def _default_model(self, model_path: str):
        from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

        # LIGHT_WHISPER_PRECISE=1: dense f32 weights + f32 compute/KV (fidelity mode)
        precise = os.environ.get("LIGHT_WHISPER_PRECISE", "") not in ("", "0")
        return Qwen3ASRModel(model_path, device=self.device, precise=precise)

    def _default_vad(self):
        from light_whisper_tpu_torch.models.vad.api import FireRedVad

        return FireRedVad(device=self.device)

    def _device_info(self) -> Dict[str, Any]:
        if self.device.type == "cuda":
            return {"device": "gpu", "device_kind": torch.cuda.get_device_name(self.device)}
        return {"device": "cpu", "device_kind": "cpu"}

    # ------------------------------------------------------------------

    def hooks(self) -> ServerHooks:
        return ServerHooks(
            initialize=self.initialize,
            transcribe=self.transcribe,
            status=self.check_status,
            stats=self.performance_stats,
            cleanup=self.cleanup,
            shutdown=self.shutdown,
        )

    def serve_forever(self) -> None:
        EngineServer(self.hooks(), logger=self.log).run()

    # ------------------------------------------------------------------

    def _resolve_model_path(self) -> Optional[str]:
        if self._explicit_model_path:
            return self._explicit_model_path
        # explicit override for self-hosted / converted artifacts and tests
        override = os.environ.get("LIGHT_WHISPER_MODEL_PATH")
        if override:
            return override if os.path.isfile(override) else None
        return find_snapshot_file(self.model_config["repo_id"], self.model_config["filename"])

    def initialize(self) -> Dict[str, Any]:
        with self._init_lock:
            return self._initialize_locked()

    def _initialize_locked(self) -> Dict[str, Any]:
        if self.initialized:
            return {"success": True, "message": "模型已初始化", "engine": self.engine}
        model_path = self._resolve_model_path()
        if not model_path:
            return {
                "success": False,
                "error": f"Qwen3-ASR Q8 模型未下载: {self.model_config['filename']}",
                "type": "models_not_downloaded",
                "engine": self.engine,
            }
        started = time.perf_counter()
        try:
            self.log.info("loading Qwen3-ASR: %s", model_path)
            t_load = time.perf_counter()
            self.model = self._model_factory(model_path)
            self._init_timings["model_load_s"] = round(time.perf_counter() - t_load, 3)
            for tag, value in getattr(self.model, "load_timings", {}).items():
                self._init_timings[f"model_load_{tag}"] = value
            self.vad = self._vad_factory()
            self._warmup()
            self.initialized = True
            self._last_load_error = None
            elapsed = time.perf_counter() - started
            return {
                "success": True,
                "message": f"Qwen3-ASR 初始化成功，耗时: {elapsed:.2f}秒",
                "model_loaded": True,
                "engine": self.engine,
                "backend": self.backend,
                **self._device_info(),
            }
        except ImportError as exc:
            self._teardown(exc)
            return {
                "success": False,
                "error": f"Qwen3-ASR 依赖加载失败: {exc}",
                "type": "import_error",
                "engine": self.engine,
            }
        except Exception as exc:
            self._teardown(exc)
            return {
                "success": False,
                "error": f"Qwen3-ASR 初始化失败: {exc}",
                "type": "init_error",
                "engine": self.engine,
            }

    def _teardown(self, exc: Exception) -> None:
        self.model = None
        self.vad = None
        self._last_load_error = str(exc)
        self.log.exception("Qwen3-ASR init failed: %s", exc)

    def _warmup(self) -> None:
        """VAD then model, serially: one device, no compile walls to overlap."""
        started = time.perf_counter()
        try:
            for tag, target in (("vad_warmup_s", self.vad), ("model_warmup_s", self.model)):
                if hasattr(target, "warmup"):
                    t0 = time.perf_counter()
                    target.warmup()
                    self._init_timings[tag] = round(time.perf_counter() - t0, 3)
            self._init_timings["warmup_total_s"] = round(time.perf_counter() - started, 3)
        except Exception as exc:
            self.log.warning("warmup failed (first request may be slow): %s", exc)

    # ------------------------------------------------------------------

    def _load_audio(self, audio_path, audio_base64, audio_format, sample_rate):
        """A request's audio as 16 kHz float32 mono, its duration and input mode.

        Inline payloads take priority over paths. Only raw PCM is accepted
        inline: rejecting WAV with the contract string triggers the client's
        temp-file fallback."""
        if audio_base64:
            decoded, duration = decode_inline_audio(audio_base64, audio_format, sample_rate)
            if not isinstance(decoded, np.ndarray):
                raise ValueError("Qwen3-ASR 内存输入仅支持 PCM")
            mode = "memory"
            audio = self._resample(decoded, sample_rate or SAMPLE_RATE)
        else:
            if not audio_path or not os.path.exists(audio_path):
                raise FileNotFoundError(f"音频文件不存在: {audio_path}")
            mode = "path"
            samples, source_rate = read_audio_file_mono_f32(audio_path)
            audio = self._resample(samples, source_rate)
            duration = audio.size / float(SAMPLE_RATE)
        return np.ascontiguousarray(audio, dtype=np.float32), duration, mode

    @staticmethod
    def _resample(audio: np.ndarray, source_rate: int) -> np.ndarray:
        return resample_linear(audio, source_rate, SAMPLE_RATE)

    def _filter_speech(self, audio: np.ndarray, session_key: str):
        """Trim leading and trailing silence only: inner pauses stay, so the
        model still sees natural phrase timing. ``vad_ms`` is the ``vad``
        span's wall."""
        with tracing.span("vad") as vad_span:
            segments = self._vad_timestamps(audio, session_key)
        vad_ms = vad_span.seconds * 1000
        with self._stats_lock:
            self._vad_calls += 1
            self._total_vad_ms += vad_ms
        start = max(0, int(segments[0]["start"])) if segments else 0
        end = min(len(audio), int(segments[-1]["end"])) if segments else 0
        if end <= start:
            with self._stats_lock:
                self._vad_rejected += 1
                self._prev_trims.pop(session_key, None)
            return np.empty(0, dtype=np.float32), 0, vad_ms
        start, end = self._stabilize_trim(audio, start, end, session_key)
        return np.ascontiguousarray(audio[start:end]), len(segments), vad_ms

    def _vad_timestamps(self, audio: np.ndarray, session_key: str):
        """Segments through the stream's ``VadPrefixSession``, which
        recomputes only the new tail of a growing buffer; with session reuse
        off, or a VAD without ``probabilities``, the stateless pass."""
        if _session_reuse_disabled() or not hasattr(self.vad, "probabilities"):
            return self.vad.speech_timestamps(audio)
        with self._stats_lock:
            session = self._vad_sessions.pop(session_key, None) or VadPrefixSession(self.vad)
            self._vad_sessions[session_key] = session  # LRU touch
            while len(self._vad_sessions) > 2 * max_sessions():
                self._vad_sessions.pop(next(iter(self._vad_sessions)))
            reused_before = session.reused_ticks
        segments = session.speech_timestamps(audio)
        with self._stats_lock:
            self._vad_prefix_reuse += session.reused_ticks - reused_before
        return segments

    def _stabilize_trim(self, raw: np.ndarray, start: int, end: int, session_key: str):
        """Pin the leading trim across a growing interim window.

        Session reuse compares the trimmed bytes, so a trim start that moves by
        a VAD hop between ticks would turn every tick into a full prefill.
        When the raw audio byte-extends the stream's previous raw audio and the
        new start lies within ``TRIM_PIN_TOLERANCE_SAMPLES`` of the previous
        one, the previous start is kept and the end stays monotone (the pinned
        boundary still lies in silence the VAD confirmed). The O(n) compare
        runs outside ``_stats_lock``."""
        if _session_reuse_disabled():
            return start, end
        if len(raw) > TRIM_PIN_MAX_SAMPLES:
            with self._stats_lock:
                self._prev_trims.pop(session_key, None)
            return start, end
        with self._stats_lock:
            prev = self._prev_trims.get(session_key)
        if prev is not None:
            prev_raw, prev_start, prev_end = prev
            if (len(raw) >= len(prev_raw) and abs(start - prev_start) <= TRIM_PIN_TOLERANCE_SAMPLES
                    and prev_start < end and np.array_equal(raw[: len(prev_raw)], prev_raw)):
                start = prev_start
                end = max(end, min(prev_end, len(raw)))
        cap = 2 * max_sessions()
        budget = _trim_pin_budget_bytes()
        with self._stats_lock:
            # at most 2x the session limit of pins and LWT_TRIM_PIN_MAX_BYTES
            # in all, oldest first out; a pin over the budget alone is dropped
            self._prev_trims.pop(session_key, None)
            if raw.nbytes <= budget:
                self._prev_trims[session_key] = (raw, start, end)
            while len(self._prev_trims) > cap or (
                len(self._prev_trims) > 1
                and sum(r.nbytes for r, _s, _e in self._prev_trims.values()) > budget
            ):
                self._prev_trims.pop(next(iter(self._prev_trims)))
        return start, end

    def _retained_audio_bytes(self) -> Dict[str, int]:
        """Host bytes kept between requests by the trim pins and the VAD
        sessions (the session pool reports its own parked audio)."""
        with self._stats_lock:
            trim = sum(r.nbytes for r, _s, _e in self._prev_trims.values())
            vad = sum(s.retained_bytes() for s in self._vad_sessions.values())
        return {"trim_pin_retained_bytes": int(trim), "vad_session_retained_bytes": int(vad)}

    def _transcribe_model(self, audio: np.ndarray, session_key: str):
        """Through the stream's KV session when there is one: a request that
        extends the stream's previous one reuses its KV prefix and verifies
        its transcript; any other resets, which gives the stateless result."""
        pool = self._streaming_sessions()
        if pool is None:
            return self.model.transcribe(audio)
        # the checkout pins the bridge: another thread's new stream must not
        # evict (reset) a session in the middle of its tick
        with pool.checkout([session_key]) as (bridge,):
            return bridge.transcribe_extending(audio)

    def _streaming_sessions(self):
        if _session_reuse_disabled():
            return None
        if self._session_pool is None:
            with self._init_lock:  # racing first requests must share ONE pool
                if self._session_pool is None:
                    try:
                        pool = SessionPool(self.model)
                        pool.bridge_for(None)  # a model without the session's needs fails here
                        self._session_pool = pool
                    except Exception:
                        self._session_pool = False
        return self._session_pool or None

    # -- multi-stream coalescing ---------------------------------------

    def _decode_scheduler(self):
        """One device job at a time; requests queued together coalesce into
        one ``transcribe_batch`` dispatch."""
        if self._scheduler is None:
            with self._init_lock:  # racing first requests must share ONE scheduler
                if self._scheduler is None:
                    from light_whisper_tpu_torch.serving.scheduler import EngineScheduler

                    self._scheduler = EngineScheduler()
        return self._scheduler

    def _submit_decode(self, audio: np.ndarray, stream: str, session_key: str):
        scheduler = self._decode_scheduler()
        job = scheduler.submit_batchable(
            stream,
            (session_key, audio),
            batch_key="transcribe",
            batch_runner=self._run_decode_batch,
            supersede=False,
            max_batch=8,
        )
        result = scheduler.wait(job)
        if isinstance(result, BaseException):
            # one stream's failure in a batched tick fails only its request
            raise result
        return result

    def _run_decode_batch(self, payloads):
        if len(payloads) == 1:
            session_key, audio = payloads[0]
            return [self._transcribe_model(audio, session_key)]
        with self._stats_lock:
            self._batched_requests += len(payloads)
            self._batch_dispatches += 1
        # distinct sessions run one batched tick that keeps every stream's KV
        # session; duplicate keys (anonymous requests share DEFAULT_STREAM)
        # cannot share one session in a tick and take the stateless batch
        pool = self._streaming_sessions()
        keys = [key for key, _audio in payloads]
        if (pool is not None and os.environ.get("LWT_BATCH_TICKS", "1") not in ("", "0")
                and len(set(keys)) == len(keys)):
            with self._stats_lock:
                self._batched_tick_dispatches += 1
            with pool.checkout(keys) as bridges:
                return transcribe_extending_batch(bridges, [audio for _key, audio in payloads])
        return self.model.transcribe_batch([audio for _key, audio in payloads])

    def _correct_hot_words(self, text: str, hot_words: Optional[List[str]]) -> str:
        if not text or not hot_words or not self._apply_hot_words:
            return text
        try:
            if self._hotword_corrector is None:
                with self._init_lock:  # worker threads race the first pass
                    if self._hotword_corrector is None:
                        from light_whisper_tpu_torch.text.hotwords import HotWordCorrector

                        self._hotword_corrector = HotWordCorrector()
            return self._hotword_corrector.correct(text, hot_words)
        except Exception as exc:  # never fail a transcription over biasing
            self.log.warning("hot-word correction failed: %s", exc)
            return text

    def transcribe(
        self,
        audio_path=None,
        options=None,
        hot_words=None,
        audio_base64=None,
        audio_format=None,
        sample_rate=None,
    ) -> Dict[str, Any]:
        if not self.initialized:
            init_result = self.initialize()
            if not init_result["success"]:
                return init_result
        input_mode = "memory" if audio_base64 else "path"
        options = options or {}
        # requests naming a stream share scheduler ordering; anonymous ones
        # each get their own, so concurrent ones can batch together
        named_stream = options.get("stream")
        stream = str(named_stream or f"req-{next(self._anon_stream)}")
        # KV sessions key on the named stream; anonymous requests share the
        # default session (a single-user client never names a stream)
        session_key = str(named_stream) if named_stream else DEFAULT_STREAM
        try:
            with tracing.span("wire.audio"):
                audio, duration, input_mode = self._load_audio(
                    audio_path, audio_base64, audio_format, sample_rate
                )
            with self._stats_lock:
                self.total_audio_duration += duration
            if duration < MIN_DURATION_SECONDS:
                return {
                    "success": True,
                    "text": "",
                    "duration": duration,
                    "engine": self.engine,
                    "input_mode": input_mode,
                }
            if options.get("long_form", duration > LONG_FORM_THRESHOLD_SECONDS):
                return self._transcribe_long_form(
                    audio, duration, input_mode, hot_words, stream,
                    max_window_seconds=options.get("long_form_max_window_seconds"),
                )
            audio, vad_segments, vad_ms = self._filter_speech(audio, session_key)
            speech_duration = len(audio) / float(SAMPLE_RATE)
            if not vad_segments:
                return {
                    "success": True,
                    "text": "",
                    "raw_text": "",
                    "duration": duration,
                    "speech_duration": 0.0,
                    "language": "unknown",
                    "engine": self.engine,
                    "model_type": self.engine,
                    "backend": self.backend,
                    "input_mode": input_mode,
                    "vad_segments": 0,
                    "vad_ms": round(vad_ms, 3),
                    "inference_ms": 0.0,
                }
            audio = as_device_audio(audio)
            started = time.perf_counter()
            result = self._submit_decode(audio, stream, session_key)
            inference_ms = (time.perf_counter() - started) * 1000
            with self._stats_lock:
                self._total_inference_ms += inference_ms
                self.transcription_count += 1
            text = self._correct_hot_words(result.text.strip(), hot_words)
            self._maybe_cleanup(duration)
            return {
                "success": True,
                "text": text,
                "raw_text": result.text.strip(),
                "confidence": 0.0,
                "duration": duration,
                "speech_duration": round(speech_duration, 3),
                "language": result.language or "unknown",
                "engine": self.engine,
                "model_type": self.engine,
                "backend": self.backend,
                "input_mode": input_mode,
                "vad_segments": vad_segments,
                "vad_ms": round(vad_ms, 3),
                "inference_ms": round(inference_ms, 3),
            }
        except Exception as exc:
            self.log.exception("transcription failed: %s", exc)
            return {
                "success": False,
                "error": f"音频转录失败: {exc}",
                "type": "transcription_error",
                "input_mode": input_mode,
            }

    def _transcribe_long_form(
        self, audio, duration, input_mode, hot_words, stream, max_window_seconds=None
    ):
        from light_whisper_tpu_torch.serving.longform import DEFAULT_MAX_WINDOW_SECONDS, transcribe_long_form

        try:
            window_s = float(max_window_seconds or DEFAULT_MAX_WINDOW_SECONDS)
        except (TypeError, ValueError):
            window_s = DEFAULT_MAX_WINDOW_SECONDS
        window_s = min(max(window_s, 1.0), DEFAULT_MAX_WINDOW_SECONDS)

        started = time.perf_counter()
        # long-form work rides the same scheduler (a plain, unbatchable job),
        # so it never interleaves with coalesced decodes
        scheduler = self._decode_scheduler()
        job = scheduler.submit(
            stream,
            lambda: transcribe_long_form(self.model, self.vad, audio, max_window_seconds=window_s),
            supersede=False,
        )
        result = scheduler.wait(job)
        total_ms = (time.perf_counter() - started) * 1000
        with self._stats_lock:
            self._vad_calls += 1
            self.transcription_count += 1
            self._total_inference_ms += total_ms
            if result.num_windows == 0:
                self._vad_rejected += 1
        text = self._correct_hot_words(result.text, hot_words)
        self._maybe_cleanup(duration)
        return {
            "success": True,
            "text": text,
            "raw_text": result.text,
            "confidence": 0.0,
            "duration": duration,
            "speech_duration": round(result.speech_seconds, 3),
            "language": result.language,
            "engine": self.engine,
            "model_type": self.engine,
            "backend": self.backend,
            "input_mode": input_mode,
            "vad_segments": result.num_windows,
            "vad_ms": round(result.vad_ms, 3),
            "inference_ms": round(total_ms, 3),
            "long_form": True,
            # per-window attribution: decode wall and planned window sizes
            "long_form_asr_ms": round(result.asr_ms, 3),
            "long_form_window_seconds": result.window_seconds,
        }

    # ------------------------------------------------------------------

    def _maybe_cleanup(self, duration: float) -> None:
        if self.transcription_count % CLEANUP_EVERY_N == 0 or duration > 120:
            threading.Thread(target=self.cleanup, daemon=True).start()

    def cleanup(self) -> None:
        import gc

        gc.collect()

    def shutdown(self) -> None:
        if self._scheduler is not None:
            self._scheduler.shutdown()
            self._scheduler = None

    def performance_stats(self) -> Dict[str, Any]:
        stats = {
            "transcription_count": self.transcription_count,
            "total_audio_duration": round(self.total_audio_duration, 2),
            "average_inference_ms": round(
                self._total_inference_ms / max(1, self.transcription_count), 3
            ),
            "average_vad_ms": round(self._total_vad_ms / max(1, self._vad_calls), 3),
            "vad_calls": self._vad_calls,
            "vad_rejected": self._vad_rejected,
            "vad_prefix_reuse": self._vad_prefix_reuse,
            "batch_dispatches": self._batch_dispatches,
            "batched_requests": self._batched_requests,
            "batched_tick_dispatches": self._batched_tick_dispatches,
            # batched ticks that raised and went per stream, and the last cause
            "batched_tick_degrades": incremental_batch.degrade_count,
            "batched_tick_last_error": incremental_batch.last_degrade_error,
            "initialized": self.initialized,
            "engine": self.engine,
            "backend": self.backend,
            # extending requests ride the speculative session path
            "speculative_decoding": not _session_reuse_disabled() and self._session_pool is not False,
            "models_loaded": {
                "asr": self.model is not None,
                "vad": self.vad is not None,
                "punc": True,
            },
            "init_phases": dict(self._init_timings),
        }
        stats.update(self._retained_audio_bytes())
        # the engine's host spans since the process started (runtime/tracing.py)
        stats["spans"] = tracing.snapshot()
        if self._session_pool:
            stats.update(self._session_pool.stats())
        if self._scheduler is not None:
            stats["scheduler"] = self._scheduler.stats()
        return stats

    def check_status(self) -> Dict[str, Any]:
        model_loaded = self.model is not None
        return {
            "success": True,
            "installed": True,
            "initialized": self.initialized,
            "version": __version__,
            "engine": self.engine,
            "backend": self.backend,
            "model_loaded": model_loaded,
            "models": {"asr": model_loaded, "vad": self.vad is not None, "punc": True},
            **self._device_info(),
        }

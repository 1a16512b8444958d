"""Qwen3-ASR engine server on PyTorch (counterpart of ``runtime/qwen3_server.py``).

:class:`Qwen3EngineServer` subclasses the reference server and overrides every
seam that reaches JAX: the backend and device report, the warmup ladder, the
session pool and incremental VAD (this port serves the stateless path), and
``transcribe`` itself. Replies keep the reference's fields one for one;
``backend`` reports ``cuda`` (or ``cpu`` when run on the CPU on purpose).

Concurrent requests coalesce through the inherited scheduler seams
(``_submit_decode`` → ``_run_decode_batch`` → ``model.transcribe_batch``), and
long recordings take the inherited ``_transcribe_long_form``
(``serving/longform.py``: VAD over the whole recording, windows, one batched
decode); both reference modules are JAX-free.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

import numpy as np
import torch

from light_whisper_tpu.runtime import qwen3_server as _reference
from light_whisper_tpu.runtime.qwen3_server import LONG_FORM_THRESHOLD_SECONDS, MIN_DURATION_SECONDS, SAMPLE_RATE
from light_whisper_tpu_torch import __version__
from light_whisper_tpu_torch.models.qwen3_asr.model import as_device_audio, resolve_device

DEFAULT_STREAM = "__default__"  # the reference session pool's anonymous-stream key


class Qwen3EngineServer(_reference.Qwen3EngineServer):
    """Engine logic on ``device``; plug into ``EngineServer`` via :meth:`hooks`."""

    def __init__(self, engine=None, device="cuda", model_factory=None, vad_factory=None, **kwargs):
        self.device = resolve_device(device)
        if model_factory is None:
            model_factory = self._default_model
        if vad_factory is None:
            vad_factory = self._default_vad
        super().__init__(engine=engine, model_factory=model_factory, vad_factory=vad_factory, **kwargs)
        self.backend = self.device.type

    def _default_model(self, model_path: str):
        from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

        precise = os.environ.get("LIGHT_WHISPER_PRECISE", "") not in ("", "0")
        return Qwen3ASRModel(model_path, device=self.device, precise=precise)

    def _default_vad(self):
        from light_whisper_tpu_torch.models.vad.api import FireRedVad

        return FireRedVad(device=self.device)

    def _device_info(self) -> Dict[str, Any]:
        if self.device.type == "cuda":
            return {"device": "gpu", "device_kind": torch.cuda.get_device_name(self.device)}
        return {"device": "cpu", "device_kind": "cpu"}

    # -- seams that reach JAX in the reference -----------------------------

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

    def _streaming_sessions(self):
        return None  # stateless path: KV session reuse is not ported yet

    def _vad_timestamps(self, audio: np.ndarray, session_key: str):
        return self.vad.speech_timestamps(audio)

    def _stabilize_trim(self, raw: np.ndarray, start: int, end: int, session_key: str):
        return start, end

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
        named_stream = options.get("stream")
        stream = str(named_stream or f"req-{next(self._anon_stream)}")
        session_key = str(named_stream) if named_stream else DEFAULT_STREAM
        with self._stats_lock:
            self._active_requests += 1
            self._device_idle.clear()
        try:
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
        finally:
            with self._stats_lock:
                self._active_requests -= 1
                if self._active_requests <= 0:
                    self._device_idle.set()

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
            "batched_tick_degrades": 0,
            "batched_tick_last_error": None,
            "initialized": self.initialized,
            "engine": self.engine,
            "backend": self.backend,
            "speculative_decoding": False,
            "models_loaded": {
                "asr": self.model is not None,
                "vad": self.vad is not None,
                "punc": True,
            },
            "init_phases": dict(self._init_timings),
        }
        stats.update(self._retained_audio_bytes())
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

"""Engine CLI of the port: ``serve`` and ``dictate``.

    python -m light_whisper_tpu_torch.runtime.engine_cli serve [--engine E] [--device cuda|cpu]
    python -m light_whisper_tpu_torch.runtime.engine_cli dictate --wav FILE [--engine E] [--no-realtime]
        [--device cuda|cpu]

``serve`` answers the line-delimited JSON protocol on stdin/stdout.
``dictate`` replays a WAV as a live dictation through the recording stack
(capture → interim loop → finalize) and prints JSON ``interim`` events and
one ``final`` event, as the reference's ``dictate`` does.

Without ``--engine`` both resolve the engine as the reference does:
``LIGHT_WHISPER_ASR_ENGINE`` when it names a local engine, then the
``engine`` field of ``engine.json`` in ``LIGHT_WHISPER_DATA_DIR``, then
``qwen3-asr-0.6b`` (an online engine there falls back to it too).

The device is ``--device`` when given, else ``cpu`` when
``LIGHT_WHISPER_FORCE_CPU`` is non-empty (the app's shell sets it to ask for
the CPU), else ``cuda``; ``cuda`` without a GPU raises rather than falling
back to the CPU. The resolved device is logged once to stderr. The model path
resolves as in the reference (``LIGHT_WHISPER_MODEL_PATH``, then the Hugging
Face cache).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

ENGINE_CHOICES = ["qwen3-asr-0.6b", "qwen3-asr-1.7b"]
SAMPLE_RATE = 16_000
BLOCK_SAMPLES = SAMPLE_RATE // 4  # 250 ms blocks, the capture callback cadence


def _configured_local_engine() -> str:
    """No ``--engine``: the variable wins, then ``engine.json``, then the
    default; online engines (glm/alibaba) cannot be served locally and fall
    back too."""
    env_engine = os.environ.get("LIGHT_WHISPER_ASR_ENGINE")
    if env_engine in ENGINE_CHOICES:
        return env_engine
    from light_whisper_tpu_torch.runtime.config import read_engine_config

    configured = read_engine_config()
    return configured if configured in ENGINE_CHOICES else ENGINE_CHOICES[0]


def requested_device(flag: Optional[str]) -> str:
    """``--device`` when given, else ``cpu`` under ``LIGHT_WHISPER_FORCE_CPU``,
    else ``cuda``."""
    if flag:
        return flag
    return "cpu" if os.environ.get("LIGHT_WHISPER_FORCE_CPU") else "cuda"


def _logger(filename: str, service: str, engine: str, device: str, flag: Optional[str]):
    from light_whisper_tpu_torch.runtime.logging_util import setup_rotating_logger

    logger = setup_rotating_logger(__name__, filename, service)
    source = "--device" if flag else ("LIGHT_WHISPER_FORCE_CPU" if device == "cpu" else "default")
    logger.info("engine %s on device %s (%s)", engine, device, source)
    return logger


def cmd_serve(engine: str, device_flag: Optional[str] = None) -> None:
    from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

    device = requested_device(device_flag)
    logger = _logger("qwen3_asr_server.log", "Qwen3-ASR server", engine, device, device_flag)
    # raises for cuda without a GPU, before the init line
    Qwen3EngineServer(engine=engine, device=device, logger=logger).serve_forever()


def dictate(model, audio, emit: Callable[..., None], realtime: bool = True, transcriber=None):
    """One dictation of ``audio`` (16 kHz float32) on a loaded ``model``.

    The audio goes in 250 ms blocks through a ``ScriptedSource`` (paced at
    its duration when ``realtime``) into a ``RecordingController`` over
    ``transcriber`` (a fresh ``IncrementalTranscriber(model)`` when None):
    ``emit("interim", ...)`` on the interim thread after each tick, then
    ``emit("final", ...)``. Returns the ``RecordingResult``."""
    from light_whisper_tpu_torch.audio.capture import ScriptedSource
    from light_whisper_tpu_torch.runtime.recording import RecordingController
    from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber

    controller = RecordingController(transcriber or IncrementalTranscriber(model))
    blocks = [audio[i : i + BLOCK_SAMPLES] for i in range(0, len(audio), BLOCK_SAMPLES)]
    source = ScriptedSource(blocks, sample_rate=SAMPLE_RATE, realtime=realtime)
    controller.start_recording(
        source,
        on_interim=lambda r: emit(
            "interim",
            stable=r.stable,
            tentative=r.tentative,
            covered_samples=r.covered_samples,
            tick_ms=round(r.tick_ms, 1),
        ),
    )
    deadline = time.time() + max(60.0, 3 * len(audio) / SAMPLE_RATE)
    while not source.drained() and time.time() < deadline:
        time.sleep(0.05)
    result = controller.stop_recording()
    emit(
        "final",
        text=result.text,
        language=result.language,
        duration_seconds=round(result.duration_seconds, 2),
        from_interim_cache=result.from_interim_cache,
        interim_ticks=result.interim_ticks,
        asr_ms=round(result.asr_ms, 1),
        too_short=result.too_short,
    )
    return result


def cmd_dictate(engine: str, wav: str, realtime: bool = True, device_flag: Optional[str] = None) -> None:
    """Replay a WAV as a live dictation: :func:`dictate` on the engine's
    model, each event a JSON line on stdout."""
    import json
    import sys

    import numpy as np

    from light_whisper_tpu_torch.audio.pcm import read_audio_file_mono_f32, resample_linear
    from light_whisper_tpu_torch.download.cache import QWEN3_ASR_MODELS, find_snapshot_file
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

    device = requested_device(device_flag)
    _logger("qwen3_asr_dictate.log", "Qwen3-ASR dictate", engine, device, device_flag)
    audio, rate = read_audio_file_mono_f32(wav)
    if rate != SAMPLE_RATE:
        audio = resample_linear(audio, rate, SAMPLE_RATE)
    audio = np.asarray(audio, dtype=np.float32)

    # the server's order: the explicit override, then the HF cache snapshot
    model_path = os.environ.get("LIGHT_WHISPER_MODEL_PATH")
    if not model_path or not os.path.isfile(model_path):
        cfg = QWEN3_ASR_MODELS[engine]
        model_path = find_snapshot_file(cfg["repo_id"], cfg["filename"])
    if not model_path:
        print(json.dumps({"event": "error", "error": "model not downloaded"}))
        raise SystemExit(2)

    def emit(kind: str, **payload) -> None:
        print(json.dumps({"event": kind, **payload}, ensure_ascii=False))
        sys.stdout.flush()

    dictate(Qwen3ASRModel(model_path, device=device), audio, emit, realtime=realtime)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="light-whisper-engine-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve_p = sub.add_parser("serve")
    serve_p.add_argument("--engine", choices=ENGINE_CHOICES)
    serve_p.add_argument("--device", choices=["cuda", "cpu"])
    dict_p = sub.add_parser("dictate")
    dict_p.add_argument("--engine", choices=ENGINE_CHOICES)
    dict_p.add_argument("--wav", required=True)
    dict_p.add_argument("--no-realtime", action="store_true",
                        help="flood audio instead of pacing it at recording speed")
    dict_p.add_argument("--device", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.command == "serve":
        cmd_serve(args.engine or _configured_local_engine(), args.device)
    elif args.command == "dictate":
        cmd_dictate(args.engine or _configured_local_engine(), args.wav, realtime=not args.no_realtime,
                    device_flag=args.device)


if __name__ == "__main__":
    main()

"""The port's engine server against the reference server on the wire.

Both serve the same tiny GGUF through ``EngineServer`` on in-memory pipes
with session reuse off; their replies to the same requests must agree on
``text``, ``raw_text``, ``language``, ``duration``, ``speech_duration`` and
``vad_segments`` (``backend`` differs by design)."""

import base64
import io
import json

import numpy as np
import pytest

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
from light_whisper_tpu.runtime.qwen3_server import Qwen3EngineServer as RefServer
from light_whisper_tpu.runtime.server import EngineServer
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

FIELDS = ("text", "raw_text", "language", "duration", "speech_duration", "vad_segments")


def _b64(audio):
    pcm = np.clip(np.round(np.asarray(audio) * 32767.0), -32768, 32767).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode()


def _requests():
    speech = speechlike(2.5, seed=5)
    padded = np.concatenate([np.zeros(8000, np.float32), speechlike(1.5, seed=6), np.zeros(8000, np.float32)])
    cmds = []
    for rid, (audio, rate) in enumerate(((speech, 16000), (padded, 16000), (np.zeros(32000), 16000),
                                         (np.zeros(4000), 16000)), start=1):
        cmds.append({"action": "transcribe", "request_id": rid, "audio_base64": _b64(audio),
                     "audio_format": "pcm_s16le", "sample_rate": rate})
    cmds += [{"action": "status", "request_id": 90}, {"action": "stats", "request_id": 91},
             {"action": "exit", "request_id": 99}]
    return cmds


def _serve(engine, cmds):
    out = io.StringIO()
    stdin = io.StringIO("".join(json.dumps(c) + "\n" for c in cmds))
    EngineServer(engine.hooks(), stdin=stdin, stdout=out, max_concurrency=1).run()
    lines = [json.loads(l) for l in out.getvalue().splitlines()]
    return lines[0], {r.get("request_id"): r for r in lines[1:]}


@pytest.fixture(scope="module")
def replies(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=2)
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGHT_WHISPER_DISABLE_SESSION_REUSE", "1")
    mp.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")
    try:
        cmds = _requests()
        ref = _serve(RefServer(model_path=path, model_factory=lambda p: RefModel(p, max_new_tokens=6)), cmds)
        port = _serve(Qwen3EngineServer(model_path=path, device="cpu",
                                        model_factory=lambda p: Qwen3ASRModel(p, device="cpu", max_new_tokens=6)),
                      cmds)
    finally:
        mp.undo()
    return ref, port


def test_init_reports_the_backend(replies):
    (_ref_init, _), (port_init, _) = replies
    assert port_init["success"] is True
    assert port_init["backend"] == "cpu" and port_init["device"] == "cpu"
    assert set(port_init) == set(_ref_init)


@pytest.mark.parametrize("rid", [1, 2, 3, 4], ids=["speech", "padded-speech", "silence", "too-short"])
def test_transcribe_replies_agree(replies, rid):
    (_, ref), (_, port) = replies
    a, b = ref[rid], port[rid]
    assert a["success"] is True and b["success"] is True
    assert set(a) == set(b)  # field for field
    for field in FIELDS:
        assert a.get(field) == b.get(field), field
    if "backend" in b:
        assert b["backend"] == "cpu"
    if rid in (1, 2):
        assert b["vad_segments"] >= 1 and b["inference_ms"] > 0
    if rid == 2:
        assert b["speech_duration"] < b["duration"]  # outer silence trimmed


def test_status_and_stats_keep_the_reference_fields(replies):
    (_, ref), (_, port) = replies
    assert set(port[90]) == set(ref[90])
    assert set(port[91]["stats"]) >= set(ref[91]["stats"]) - {"scheduler"}
    assert port[91]["stats"]["backend"] == "cpu"
    assert port[91]["stats"]["transcription_count"] == ref[91]["stats"]["transcription_count"]
    assert port[99]["success"] is True


def test_cuda_server_without_a_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Qwen3EngineServer(device="cuda")

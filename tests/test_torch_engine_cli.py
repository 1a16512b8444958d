"""The port's engine CLI picks the engine and the device as it should.

- Without ``--engine``, the port's resolver and the reference's
  ``_configured_local_engine`` give the same engine under the same
  environment and the same ``engine.json`` in ``LIGHT_WHISPER_DATA_DIR``; the
  port's copy of the ``engine.json`` readers agrees with the original.
- ``--device`` resolves as the flag, then ``LIGHT_WHISPER_FORCE_CPU``, then
  ``cuda``; ``JAX_PLATFORMS`` is not the port's switch.
- ``serve`` and ``dictate`` with no ``--engine`` hand the resolved engine on
  (a stub server class: no model loads), and ``cuda`` without a GPU raises
  rather than falling back to the CPU.
- One in-process ``engine_cli dictate --no-realtime --device cpu`` on the
  tiny fixture prints the reference's event names and fields, and its final
  text is a fresh ``IncrementalTranscriber``'s of the whole clip (or, from the
  interim cache, the last tick's).
"""

import json

import pytest
import torch

from helpers.tiny_model import write_tiny_model

from light_whisper_tpu.runtime import config as ref_config
from light_whisper_tpu.runtime import engine_cli as ref_cli
from light_whisper_tpu_torch.runtime import config as port_config
from light_whisper_tpu_torch.runtime import engine_cli as port_cli

ENGINE_CASES = {
    "variable-local": ("qwen3-asr-1.7b", None),
    "variable-online-json-1.7b": ("glm-asr", {"engine": "qwen3-asr-1.7b"}),
    "json-1.7b": (None, {"engine": "qwen3-asr-1.7b"}),
    "json-online": (None, {"engine": "glm-asr"}),
    "json-malformed": (None, "{not json"),
    "json-not-an-object": (None, ["qwen3-asr-1.7b"]),
    "json-unknown-engine": ("whisper-large", {"engine": "whisper-large"}),
    "nothing": (None, None),
}


def _configure(monkeypatch, tmp_path, variable, engine_json):
    monkeypatch.setenv("LIGHT_WHISPER_DATA_DIR", str(tmp_path))
    if variable is None:
        monkeypatch.delenv("LIGHT_WHISPER_ASR_ENGINE", raising=False)
    else:
        monkeypatch.setenv("LIGHT_WHISPER_ASR_ENGINE", variable)
    if engine_json is not None:
        text = engine_json if isinstance(engine_json, str) else json.dumps(engine_json)
        (tmp_path / "engine.json").write_text(text, encoding="utf-8")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_resolution_matches_the_reference(monkeypatch, tmp_path, case):
    _configure(monkeypatch, tmp_path, *ENGINE_CASES[case])
    got = port_cli._configured_local_engine()
    assert got == ref_cli._configured_local_engine()
    assert got in port_cli.ENGINE_CHOICES
    assert port_config.engine_config_path() == ref_config.engine_config_path() == str(tmp_path / "engine.json")
    assert port_config.read_engine_json() == ref_config.read_engine_json()
    assert port_config.read_engine_config() == ref_config.read_engine_config()


def test_engine_cases_cover_each_source(monkeypatch, tmp_path):
    want = {"variable-local": "qwen3-asr-1.7b", "variable-online-json-1.7b": "qwen3-asr-1.7b",
            "json-1.7b": "qwen3-asr-1.7b", "json-online": "qwen3-asr-0.6b", "json-malformed": "qwen3-asr-0.6b",
            "nothing": "qwen3-asr-0.6b"}
    for case, engine in want.items():
        (tmp_path / "engine.json").unlink(missing_ok=True)
        _configure(monkeypatch, tmp_path, *ENGINE_CASES[case])
        assert port_cli._configured_local_engine() == engine, case


def test_config_constants_match_the_reference():
    assert port_config.VALID_ENGINES == ref_config.VALID_ENGINES
    assert port_config.DEFAULT_ENGINE == ref_config.DEFAULT_ENGINE
    assert port_cli.ENGINE_CHOICES == ref_cli.ENGINE_CHOICES


@pytest.mark.parametrize("flag,force_cpu,want", [
    ("cuda", "1", "cuda"),
    ("cpu", None, "cpu"),
    ("cuda", None, "cuda"),
    (None, "1", "cpu"),
    (None, "", "cuda"),
    (None, None, "cuda"),
], ids=["flag-over-variable", "flag-cpu", "flag-cuda", "variable", "empty-variable", "default"])
def test_device_order(monkeypatch, flag, force_cpu, want):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # a JAX switch: the port ignores it
    if force_cpu is None:
        monkeypatch.delenv("LIGHT_WHISPER_FORCE_CPU", raising=False)
    else:
        monkeypatch.setenv("LIGHT_WHISPER_FORCE_CPU", force_cpu)
    assert port_cli.requested_device(flag) == want


class StubServer:
    made = []

    def __init__(self, engine=None, device="cuda", logger=None, **kwargs):
        StubServer.made.append((engine, device))

    def serve_forever(self):
        pass


@pytest.mark.parametrize("case,argv,force_cpu,want", [
    ("variable-local", ["serve"], None, ("qwen3-asr-1.7b", "cuda")),
    ("json-1.7b", ["serve"], "1", ("qwen3-asr-1.7b", "cpu")),
    ("json-online", ["serve", "--device", "cpu"], None, ("qwen3-asr-0.6b", "cpu")),
    ("variable-local", ["serve", "--engine", "qwen3-asr-0.6b"], None, ("qwen3-asr-0.6b", "cuda")),
], ids=["variable", "json-force-cpu", "online-falls-back", "flag-wins"])
def test_serve_hands_the_resolved_engine_to_the_server(monkeypatch, tmp_path, case, argv, force_cpu, want):
    from light_whisper_tpu_torch.runtime import qwen3_server

    _configure(monkeypatch, tmp_path, *ENGINE_CASES[case])
    if force_cpu is None:
        monkeypatch.delenv("LIGHT_WHISPER_FORCE_CPU", raising=False)
    else:
        monkeypatch.setenv("LIGHT_WHISPER_FORCE_CPU", force_cpu)
    monkeypatch.setattr(qwen3_server, "Qwen3EngineServer", StubServer)
    StubServer.made.clear()
    port_cli.main(argv)
    assert StubServer.made == [want]


def test_dictate_hands_the_resolved_engine_on(monkeypatch, tmp_path):
    _configure(monkeypatch, tmp_path, None, {"engine": "qwen3-asr-1.7b"})
    calls = []
    monkeypatch.setattr(port_cli, "cmd_dictate", lambda *args, **kwargs: calls.append((args, kwargs)))
    port_cli.main(["dictate", "--wav", "x.wav", "--no-realtime"])
    port_cli.main(["dictate", "--wav", "y.wav", "--engine", "qwen3-asr-0.6b", "--device", "cpu"])
    assert calls == [(("qwen3-asr-1.7b", "x.wav"), {"realtime": False, "device_flag": None}),
                     (("qwen3-asr-0.6b", "y.wav"), {"realtime": True, "device_flag": "cpu"})]


def test_dictate_without_a_model_reports_it(monkeypatch, tmp_path, capsys):
    from light_whisper_tpu_torch.audio.pcm import encode_wav_mono_s16

    wav = tmp_path / "a.wav"
    wav.write_bytes(encode_wav_mono_s16(torch.zeros(8000).numpy(), 16000))
    monkeypatch.setenv("LIGHT_WHISPER_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setenv("LIGHT_WHISPER_MODEL_PATH", str(tmp_path / "missing.gguf"))
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["dictate", "--wav", str(wav), "--device", "cpu"])
    assert exc.value.code == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "event": "error", "error": "model not downloaded"}


def test_dictate_on_cuda_without_a_gpu_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from light_whisper_tpu_torch.audio.pcm import encode_wav_mono_s16

    model = tmp_path / "model.gguf"
    model.write_bytes(b"GGUF")  # never read: the device check comes first
    wav = tmp_path / "a.wav"
    wav.write_bytes(encode_wav_mono_s16(torch.zeros(8000).numpy(), 16000))
    monkeypatch.setenv("LIGHT_WHISPER_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("LIGHT_WHISPER_MODEL_PATH", str(model))
    monkeypatch.delenv("LIGHT_WHISPER_FORCE_CPU", raising=False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_cli.main(["dictate", "--wav", str(wav)])


def test_engine_cli_dictate_on_the_cpu(tmp_path, monkeypatch, capsys):
    from light_whisper_tpu_torch.audio.pcm import encode_wav_mono_s16, read_audio_file_mono_f32
    from light_whisper_tpu_torch.eval.speechlike import speechlike
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
    from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber

    model_path = str(tmp_path / "tiny.gguf")
    write_tiny_model(model_path, quantize=True, seed=0)
    wav = tmp_path / "dictate.wav"
    wav.write_bytes(encode_wav_mono_s16(speechlike(1.5, seed=12), 16000))
    monkeypatch.setenv("LIGHT_WHISPER_MODEL_PATH", model_path)
    monkeypatch.setenv("LIGHT_WHISPER_DATA_DIR", str(tmp_path))
    port_cli.main(["dictate", "--wav", str(wav), "--no-realtime", "--device", "cpu"])
    *interims, final = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    for event in interims:
        assert list(event) == ["event", "stable", "tentative", "covered_samples", "tick_ms"]
        assert event["event"] == "interim" and 0 < event["covered_samples"] <= 24_000
    assert list(final) == ["event", "text", "language", "duration_seconds", "from_interim_cache",
                           "interim_ticks", "asr_ms", "too_short"]
    assert final["event"] == "final" and final["duration_seconds"] == 1.5 and final["too_short"] is False
    assert final["interim_ticks"] == len(interims) and 0 <= len(interims) <= 8
    assert final["asr_ms"] >= 0 and final["text"]
    if final["from_interim_cache"]:
        assert final["text"] == interims[-1]["stable"] + interims[-1]["tentative"]
    else:
        clip, _rate = read_audio_file_mono_f32(str(wav))
        model = Qwen3ASRModel(model_path, device="cpu")
        assert final["text"] == IncrementalTranscriber(model).transcribe(clip).text

"""The plain reference against the port at tiny widths: the VAD trim, and the
logits of the port's precise (float32) model."""

import numpy as np
import pytest
import torch

from harness import artifact, traffic
from harness.reference import Reference

from conftest import QWEN3_ASR, tiny_config

MIX = {"loop": "closed", "clips": 3,
       "speech_seconds": {"distribution": "lognormal", "median": 4.0, "sigma": 0.6, "min": 2.0, "max": 20.0},
       "lead_silence_seconds": 0.3, "trail_silence_seconds": 0.5, "silence_noise_lsb": 3.0, "clients": 1, "cycles": 1}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg = tiny_config()
    path = str(tmp_path_factory.mktemp("art") / "tiny.gguf")
    artifact.write(path, QWEN3_ASR, QWEN3_ASR.shapes(cfg), cfg["weights_seed"], "cpu")
    return cfg, path, traffic.generate(MIX, 21)


def test_trim_matches_the_engine_vad(tiny):
    from light_whisper_tpu_torch.models.vad.api import FireRedVad

    cfg, _path, t = tiny
    vad, ref = FireRedVad(device="cpu"), Reference(cfg, QWEN3_ASR, "cpu")
    for pcm in t.utterances:
        segs = vad.speech_timestamps(pcm.astype(np.float32) / 32768.0)
        trimmed, n = ref.vad.trim(pcm)
        assert n == len(segs) >= 1
        assert len(trimmed) == segs[-1]["end"] - segs[0]["start"]


def test_logits_match_the_precise_model(tiny):
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

    cfg, path, t = tiny
    model = Qwen3ASRModel(path, device="cpu", max_new_tokens=6, precise=True)
    ref = Reference(cfg, QWEN3_ASR, "cpu")
    s = QWEN3_ASR.shapes(cfg)
    for pcm in t.utterances:
        trimmed, _n = ref.vad.trim(pcm)
        tokens = model.transcribe(trimmed).tokens
        assert len(tokens) == 6 and all(256 <= x < s.vocab for x in tokens)
        got = torch.stack(model.teacher_forced_logits(trimmed, tokens)[: len(tokens)])[:, : s.vocab]
        want = ref.score([(trimmed, tokens)])[0]["ref"]
        assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_served_text_names_its_tokens():
    assert artifact.parse_tokens("<000300><151000>") == [300, 151000]
    assert artifact.parse_tokens("<000300> <151000>") is None
    assert artifact.parse_tokens("") == []

"""A long recording decoded as one context (``"long_form": false``), on the CPU.

The path the card's ``single-pass`` phase drives, at a tiny width: a 300 s
request through the port's wire server takes no long-form windows, its prompt
of 3,968 rows meets a KV cache of 8192 slots, and every layer's prefill
attention takes the online softmax (``attention_chunked`` here; the
flash-prefill kernel on the card). The reply keeps the short path's fields.
"""

import base64
import dataclasses
import io
import json

import numpy as np
import pytest

from helpers.tiny_model import tiny_config, tiny_tensors, tiny_vocab
from light_whisper_tpu.models.qwen3_asr.export import write_model
from light_whisper_tpu_torch.eval.speechlike import speechlike
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.runtime.server import EngineServer
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer


@pytest.fixture(scope="module")
def long_context_gguf(tmp_path_factory):
    """The tiny fixture with the 0.6B context limit (32,768), so that a
    5-minute prompt fits one cache."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, context_length=32_768))
    tokens, types = tiny_vocab()
    meta = {"tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types, "tokenizer.ggml.merges": [],
            "tokenizer.chat_template": "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n"}
    path = str(tmp_path_factory.mktemp("singlepass") / "tiny-32k.gguf")
    write_model(path, cfg, tiny_tensors(cfg, seed=6), meta, quantize=True)
    return path


def test_a_300_s_request_is_one_context_at_capacity_8192(long_context_gguf, monkeypatch):
    routes, capacities = [], []
    real_chunked = dec.attention_chunked
    monkeypatch.setattr(dec, "attention_chunked", lambda *a: routes.append(a[0].shape[0]) or real_chunked(*a))
    real_init = dec.init_cache
    monkeypatch.setattr(dec, "init_cache",
                        lambda cfg, capacity, *a, **k: capacities.append(capacity) or real_init(cfg, capacity, *a, **k))

    # the cache holds the prompt and the decode budget: 3,968 + 200 slots need 8192
    engine = Qwen3EngineServer(model_path=long_context_gguf, device="cpu",
                               model_factory=lambda p: Qwen3ASRModel(p, device="cpu", max_new_tokens=200))
    assert engine.initialize()["success"]
    routes.clear()
    capacities.clear()
    pcm = np.round(speechlike(300.0, seed=8) * 32767).astype("<i2")
    cmd = {"action": "transcribe", "request_id": 1, "audio_base64": base64.b64encode(pcm.tobytes()).decode(),
           "audio_format": "pcm_s16le", "sample_rate": 16000, "options": {"long_form": False}}
    out = io.StringIO()
    EngineServer(engine.hooks(), stdin=io.StringIO(json.dumps(cmd) + "\n"), stdout=out).run()
    _init, reply = [json.loads(line) for line in out.getvalue().splitlines()]

    assert reply["success"] is True and reply["request_id"] == 1
    assert not any(key.startswith("long_form") for key in reply)
    assert reply["vad_segments"] >= 1 and reply["duration"] == 300.0
    assert capacities == [8192]
    layers = engine.model.config.decoder.block_count
    assert routes == [3968] * layers  # one prefill of 3,968 rows, once a layer
    assert len(engine.model.last_decode_step_s) <= 199  # no step after the last recordable token

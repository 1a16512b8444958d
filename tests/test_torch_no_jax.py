"""The port never imports JAX (nor ml_dtypes, which the card's machine lacks).

A fresh interpreter builds the port's server on the CPU over a tiny GGUF,
answers one ``transcribe`` through ``EngineServer`` and then lists what got
imported. Asking for the CUDA device on a machine without a GPU raises, and
``engine_cli serve`` without ``--device cpu`` fails loudly instead of
serving on the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from helpers.tiny_model import write_tiny_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import base64, io, json, sys
import numpy as np
import torch
from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.runtime.server import EngineServer
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

path = sys.argv[1]
pcm = np.round(speechlike(2.0, seed=1) * 32767).astype("<i2")
cmd = {"action": "transcribe", "request_id": 1, "audio_base64": base64.b64encode(pcm.tobytes()).decode(),
       "audio_format": "pcm_s16le", "sample_rate": 16000}
out = io.StringIO()
server = Qwen3EngineServer(model_path=path, device="cpu",
                           model_factory=lambda p: Qwen3ASRModel(p, device="cpu", max_new_tokens=4))
EngineServer(server.hooks(), stdin=io.StringIO(json.dumps(cmd) + "\n"), stdout=out).run()
replies = [json.loads(l) for l in out.getvalue().splitlines()]
cuda_error = None
if not torch.cuda.is_available():
    try:
        Qwen3ASRModel(path, device="cuda")
    except RuntimeError as exc:
        cuda_error = str(exc)
print(json.dumps({"replies": replies, "cuda_error": cuda_error,
                  "modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes"))}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    env["LIGHT_WHISPER_DISABLE_SESSION_REUSE"] = "1"
    return env


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nojax") / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=1)
    return path


def test_port_serves_without_importing_jax(tiny_gguf):
    proc = subprocess.run([sys.executable, "-c", SCRIPT, tiny_gguf], capture_output=True, text=True,
                          env=_env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    init, reply = result["replies"]
    assert init["success"] is True and init["backend"] == "cpu"
    assert reply["success"] is True and reply["vad_segments"] >= 1
    assert result["modules"] == []
    if not torch.cuda.is_available():
        assert "CUDA" in result["cuda_error"]


def test_engine_cli_without_a_gpu_fails_loudly(tiny_gguf):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = _env()
    env["LIGHT_WHISPER_MODEL_PATH"] = tiny_gguf
    proc = subprocess.run(
        [sys.executable, "-m", "light_whisper_tpu_torch.runtime.engine_cli", "serve", "--engine", "qwen3-asr-0.6b"],
        input='{"action": "exit", "request_id": 1}\n', capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""  # no init line: nothing was served on the CPU
    assert "torch.cuda.is_available() is false" in proc.stderr

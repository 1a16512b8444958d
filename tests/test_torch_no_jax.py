"""The port never imports JAX (nor ml_dtypes, which the card's machine lacks),
nor any module of the JAX package ``light_whisper_tpu``.

A fresh interpreter builds the port's server on the CPU over a tiny GGUF,
with audio and the wire loop from the port's own modules, answers through
``EngineServer`` one ``transcribe``, then a pair of transcribes coalesced
into one batch (queued behind a busy device) and a ``long_form`` request,
and then lists what got imported; a second one runs one interim tick pair of
``IncrementalTranscriber``, two pooled wire requests with session reuse on
and one ``engine_cli dictate``. Asking for the CUDA device on a machine
without a GPU raises, and ``engine_cli serve`` without ``--device cpu`` (or
``LIGHT_WHISPER_FORCE_CPU``) fails loudly instead of serving on the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from helpers.tiny_model import write_tiny_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import base64, io, json, sys, threading, time
import numpy as np
import torch
from light_whisper_tpu_torch.eval.speechlike import speechlike
from light_whisper_tpu_torch.runtime.server import EngineServer
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

path = sys.argv[1]

def transcribe(rid, audio, **options):
    pcm = np.round(audio * 32767).astype("<i2")
    cmd = {"action": "transcribe", "audio_base64": base64.b64encode(pcm.tobytes()).decode(),
           "audio_format": "pcm_s16le", "sample_rate": 16000, "options": options}
    if rid is not None:
        cmd["request_id"] = rid
    return json.dumps(cmd) + "\n"

def serve(server, lines):
    out = io.StringIO()
    EngineServer(server.hooks(), stdin=io.StringIO("".join(lines)), stdout=out).run()
    return [json.loads(l) for l in out.getvalue().splitlines()]

def make():
    return Qwen3EngineServer(model_path=path, device="cpu",
                             model_factory=lambda p: Qwen3ASRModel(p, device="cpu", max_new_tokens=4))

replies = serve(make(), [transcribe(1, speechlike(2.0, seed=1))])

# a busy device: two requests queue behind it and coalesce; the long-form
# request (no request_id: served in order) waits for both
server = make()
server.initialize()
scheduler = server._decode_scheduler()
running, release = threading.Event(), threading.Event()
scheduler.submit("busy", lambda: (running.set(), release.wait(60)), supersede=False)
running.wait(10)

def release_when_queued():
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and len(scheduler._queue) < 2:
        time.sleep(0.005)
    release.set()

threading.Thread(target=release_when_queued, daemon=True).start()
recording = np.concatenate([speechlike(2.0, seed=3), np.zeros(16000, np.float32), speechlike(2.0, seed=4)])
more = serve(server, [transcribe(2, speechlike(2.0, seed=2)), transcribe(3, speechlike(2.5, seed=5)),
                      transcribe(None, recording, long_form=True, long_form_max_window_seconds=3.0),
                      json.dumps({"action": "stats", "request_id": 4}) + "\n"])
cuda_error = None
if not torch.cuda.is_available():
    try:
        Qwen3ASRModel(path, device="cuda")
    except RuntimeError as exc:
        cuda_error = str(exc)
print(json.dumps({"replies": replies, "more": more, "cuda_error": cuda_error,
                  "modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")),
                  "reference": sorted(m for m in sys.modules
                                      if m.split(".")[0] in ("light_whisper_tpu", "__graft_entry__", "helpers"))}))
"""


SESSION_SCRIPT = r"""
import base64, contextlib, io, json, os, sys
import numpy as np
from light_whisper_tpu_torch.eval.speechlike import speechlike
from light_whisper_tpu_torch.runtime.server import EngineServer
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber

path = sys.argv[1]
model = Qwen3ASRModel(path, device="cpu", max_new_tokens=4)
audio = speechlike(3.0, seed=1)
inc = IncrementalTranscriber(model, max_new_tokens=4)
tick = inc.transcribe_window(audio[:32000]).tokens, inc.transcribe_window(audio).tokens

def transcribe(rid, clip):
    pcm = np.round(clip * 32767).astype("<i2")
    return json.dumps({"action": "transcribe", "request_id": rid, "audio_base64": base64.b64encode(pcm.tobytes()).decode(),
                       "audio_format": "pcm_s16le", "sample_rate": 16000, "options": {"stream": "s"}}) + "\n"

out = io.StringIO()
server = Qwen3EngineServer(model_path=path, device="cpu", model_factory=lambda p: model)
EngineServer(server.hooks(), stdin=io.StringIO(transcribe(1, audio[:32000]) + transcribe(2, audio)
                                               + json.dumps({"action": "stats"}) + "\n"), stdout=out,
             max_concurrency=1).run()  # one at a time: the second request extends the first
# one dictation through engine_cli, on the CPU that LIGHT_WHISPER_FORCE_CPU asks for
from light_whisper_tpu_torch.audio.pcm import encode_wav_mono_s16
from light_whisper_tpu_torch.runtime import engine_cli
wav = os.path.join(os.path.dirname(path), "dictate.wav")
with open(wav, "wb") as f:
    f.write(encode_wav_mono_s16(speechlike(1.5, seed=2), 16000))
os.environ.update(LIGHT_WHISPER_MODEL_PATH=path, LIGHT_WHISPER_FORCE_CPU="1")
events = io.StringIO()
with contextlib.redirect_stdout(events):
    engine_cli.main(["dictate", "--wav", wav, "--no-realtime"])
print(json.dumps({"tick": tick, "counters": [inc.full_prefills, inc.incremental_prefills],
                  "dictate": [json.loads(l) for l in events.getvalue().splitlines()],
                  "replies": [json.loads(l) for l in out.getvalue().splitlines()],
                  "modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")),
                  "reference": sorted(m for m in sys.modules
                                      if m.split(".")[0] in ("light_whisper_tpu", "__graft_entry__", "helpers"))}))
"""


def _env(session_reuse=False):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    if session_reuse:
        env.pop("LIGHT_WHISPER_DISABLE_SESSION_REUSE", None)
    else:
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
    _init, first, second, long_form, stats = result["more"]
    assert {first["request_id"], second["request_id"]} == {2, 3}
    assert first["success"] and second["success"] and "request_id" not in long_form
    assert long_form["success"] is True and long_form["long_form"] is True and long_form["vad_segments"] >= 2
    assert stats["stats"]["batch_dispatches"] == 1 and stats["stats"]["batched_requests"] == 2
    assert result["modules"] == []
    assert result["reference"] == []
    if not torch.cuda.is_available():
        assert "CUDA" in result["cuda_error"]


def test_interim_tick_and_pooled_request_without_importing_jax(tiny_gguf):
    """One tick pair of ``IncrementalTranscriber``, two pooled wire requests
    on a named stream (session reuse on) and one ``engine_cli dictate`` with
    ``LIGHT_WHISPER_FORCE_CPU`` set, then the module list."""
    proc = subprocess.run([sys.executable, "-c", SESSION_SCRIPT, tiny_gguf], capture_output=True, text=True,
                          env=_env(session_reuse=True), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["counters"] == [1, 1] and all(len(t) >= 1 for t in result["tick"])
    init, first, second, stats = result["replies"]
    assert init["success"] and first["success"] and second["success"]
    assert stats["stats"]["session_hits"] == 1 and stats["stats"]["speculative_decoding"] is True
    assert stats["stats"]["vad_prefix_reuse"] >= 1
    *_interims, final = result["dictate"]
    assert final["event"] == "final" and final["duration_seconds"] == 1.5 and final["text"]
    assert "on device cpu (LIGHT_WHISPER_FORCE_CPU)" in proc.stderr
    assert result["modules"] == []
    assert result["reference"] == []


MESH_SCRIPT = r"""
import json, os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.parallel import dryrun, encoder_sp, mesh, pipeline, sharding
from light_whisper_tpu_torch.models.qwen3_asr import synthetic
path = sys.argv[1]
with tempfile.TemporaryDirectory() as d:
    mesh.init_distributed("cpu", 0, 1, store=dist.FileStore(os.path.join(d, "store"), 1), timeout_s=60)
    try:
        m = mesh.make_mesh(1, 1, device_type="cpu")
        model = Qwen3ASRModel(path, max_new_tokens=4, mesh=m)
        audio = (np.random.default_rng(0).standard_normal(8000) * 0.3).astype(np.float32)
        tokens = [r.tokens for r in dryrun.transcribe_batch_dp(model, [audio, audio[:6000]], m)]
    finally:
        dist.destroy_process_group()
print(json.dumps({"tokens": tokens,
                  "modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")),
                  "reference": sorted(m for m in sys.modules
                                      if m.split(".")[0] in ("light_whisper_tpu", "__graft_entry__", "helpers"))}))
"""


def test_multi_device_modules_without_importing_jax(tiny_gguf):
    """The multi-device modules (``parallel/encoder_sp.py``, ``pipeline.py``,
    ``dryrun.py``, ``sharding.py``, ``models/qwen3_asr/synthetic.py``)
    imported, and a dp1 x tp1 model serving a dp-split batch over a
    one-rank gloo group, then the module list."""
    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT, tiny_gguf], capture_output=True, text=True,
                          env=_env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(result["tokens"]) == 2 and all(len(t) >= 1 for t in result["tokens"])
    assert result["modules"] == []
    assert result["reference"] == []


def test_engine_cli_without_a_gpu_fails_loudly(tiny_gguf):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = _env()
    env["LIGHT_WHISPER_MODEL_PATH"] = tiny_gguf
    env.pop("LIGHT_WHISPER_FORCE_CPU", None)  # the explicit CPU request
    proc = subprocess.run(
        [sys.executable, "-m", "light_whisper_tpu_torch.runtime.engine_cli", "serve", "--engine", "qwen3-asr-0.6b"],
        input='{"action": "exit", "request_id": 1}\n', capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""  # no init line: nothing was served on the CPU
    assert "torch.cuda.is_available() is false" in proc.stderr

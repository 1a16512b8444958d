"""Coalesced and long-form wire requests: the port's engine server against the
reference's, on the CPU over one tiny GGUF, session reuse off.

- Two transcribes queued together behind a busy device coalesce into ONE
  ``transcribe_batch`` dispatch (``batch_dispatches == 1``,
  ``batched_requests == 2``), and each reply's text is the reference's.
- A long-form request (``options.long_form``, or any request longer than
  ``LONG_FORM_THRESHOLD_SECONDS``) goes through ``serving/longform.py``: VAD
  over the whole recording, windows, one batched decode. Its reply carries
  the reference's keys, among them ``long_form``, ``long_form_asr_ms`` and
  ``long_form_window_seconds``, with the same windows and text.
"""

import base64
import json
import os
import threading
import time

import numpy as np
import pytest

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
from light_whisper_tpu.runtime.qwen3_server import LONG_FORM_THRESHOLD_SECONDS
from light_whisper_tpu.runtime.qwen3_server import Qwen3EngineServer as RefServer
from light_whisper_tpu.runtime.server import EngineServer
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.runtime import qwen3_server as port_server
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

MAX_NEW = 6


def _b64(audio):
    pcm = np.clip(np.round(np.asarray(audio) * 32767.0), -32768, 32767).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode()


def _transcribe(rid, audio, **options):
    cmd = {"action": "transcribe", "request_id": rid, "audio_base64": _b64(audio),
           "audio_format": "pcm_s16le", "sample_rate": 16000}
    if options:
        cmd["options"] = options
    return cmd


def _recording():
    """Two stretches of speech around a pause: two VAD segments."""
    return np.concatenate([np.zeros(8000, np.float32), speechlike(2.5, seed=21), np.zeros(16000, np.float32),
                           speechlike(2.0, seed=22), np.zeros(8000, np.float32)])


class Conversation:
    """Full-duplex client over OS pipes around a threaded ``EngineServer``."""

    def __init__(self, engine):
        c2s_r, c2s_w = os.pipe()
        s2c_r, s2c_w = os.pipe()
        self._to_server = os.fdopen(c2s_w, "w")
        self._from_server = os.fdopen(s2c_r, "r")
        self.server = EngineServer(engine.hooks(), stdin=os.fdopen(c2s_r, "r"), stdout=os.fdopen(s2c_w, "w"))
        self.thread = threading.Thread(target=self.server.run, daemon=True)
        self.thread.start()

    def send(self, cmd):
        self._to_server.write(json.dumps(cmd) + "\n")
        self._to_server.flush()

    def recv(self):
        return json.loads(self._from_server.readline())

    def close(self):
        self.send({"action": "exit", "request_id": 10_000})
        while self.recv().get("request_id") != 10_000:
            pass
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _block_scheduler(engine):
    """Occupy the device scheduler so queued jobs pile up deterministically."""
    scheduler = engine._decode_scheduler()
    running, release = threading.Event(), threading.Event()

    def blocker():
        running.set()
        assert release.wait(60)

    scheduler.submit("blocker", blocker, supersede=False)
    assert running.wait(10)
    return scheduler, release


def _wait_for_queue(scheduler, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with scheduler._lock:
            if len(scheduler._queue) >= n:
                return
        time.sleep(0.005)
    raise AssertionError(f"scheduler queue never reached {n} jobs")


def _coalesced_pair(engine):
    conv = Conversation(engine)
    assert conv.recv()["success"]  # init reply
    scheduler, release = _block_scheduler(engine)
    conv.send(_transcribe(1, speechlike(2.0, seed=11)))
    conv.send(_transcribe(2, speechlike(3.1, seed=12)))
    _wait_for_queue(scheduler, 2)
    release.set()
    replies = {r["request_id"]: r for r in (conv.recv(), conv.recv())}
    conv.close()
    return replies, engine.performance_stats()


def _serve(engine, cmds):
    conv = Conversation(engine)
    assert conv.recv()["success"]
    replies = {}
    for cmd in cmds:
        conv.send(cmd)
        reply = conv.recv()
        replies[reply["request_id"]] = reply
    conv.close()
    return replies


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("batchsrv") / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=3)
    mp = pytest.MonkeyPatch()
    mp.setenv("LIGHT_WHISPER_DISABLE_SESSION_REUSE", "1")
    mp.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")

    def make():
        ref = RefServer(model_path=path, model_factory=lambda p: RefModel(p, max_new_tokens=MAX_NEW))
        port = Qwen3EngineServer(model_path=path, device="cpu",
                                 model_factory=lambda p: Qwen3ASRModel(p, device="cpu", max_new_tokens=MAX_NEW))
        return ref, port

    yield make
    mp.undo()


def _record_batches(engine):
    """Wrap the served model's ``transcribe_batch``: (clips, results) per call."""
    calls = []
    model = engine.model
    real = model.transcribe_batch

    def recording(clips):
        results = real(clips)
        calls.append(([np.array(c) for c in clips], results))
        return results

    model.transcribe_batch = recording
    return calls


def test_concurrent_transcribes_coalesce_into_one_batch(engines):
    """Both servers hand the model the same two VAD-trimmed clips in one
    batch; the port's replies carry its batch's texts. (Token parity of the
    two packages' ``transcribe_batch`` is held in test_torch_batch_model.py;
    on this fixture's flat logits the encoders' one-bf16-ulp difference may
    move a near-tie token, so the texts are not compared across packages.)"""
    ref, port = engines()
    for engine in (ref, port):
        assert engine.initialize()["success"]
    ref_calls, calls = _record_batches(ref), _record_batches(port)
    (want, ref_stats), (got, stats) = _coalesced_pair(ref), _coalesced_pair(port)
    assert stats["batch_dispatches"] == 1 == ref_stats["batch_dispatches"]
    assert stats["batched_requests"] == 2 == ref_stats["batched_requests"]
    assert len(calls) == 1 == len(ref_calls)
    (clips, results), (ref_clips, _) = calls[0], ref_calls[0]
    by_len = lambda cs: sorted((len(c), c.tobytes()) for c in cs)  # noqa: E731
    assert len(clips) == 2 and by_len(clips) == by_len(ref_clips)
    texts = {r.text.strip() for r in results}
    for rid in (1, 2):
        assert got[rid]["success"] is True and got[rid]["backend"] == "cpu"
        assert set(got[rid]) == set(want[rid])
        assert got[rid]["text"] in texts
        for field in ("duration", "speech_duration", "vad_segments"):
            assert got[rid][field] == want[rid][field], (rid, field)


def test_long_form_reply_matches_the_reference(engines):
    ref, port = engines()
    cmds = [_transcribe(1, _recording(), long_form=True, long_form_max_window_seconds=3.0),
            _transcribe(2, _recording(), long_form=True)]
    want, got = _serve(ref, cmds), _serve(port, cmds)
    for rid in (1, 2):
        a, b = want[rid], got[rid]
        assert a["success"] is True and b["success"] is True
        assert set(b) == set(a)  # the reference's keys, long_form_* included
        assert b["long_form"] is True and b["backend"] == "cpu"
        assert b["long_form_window_seconds"] == a["long_form_window_seconds"]
        for field in ("text", "raw_text", "language", "duration", "speech_duration", "vad_segments"):
            assert b[field] == a[field], (rid, field)
        assert b["long_form_asr_ms"] > 0 and b["inference_ms"] >= b["long_form_asr_ms"]
    # a 3 s window budget splits the recording at its pause; the default keeps one window
    assert got[1]["vad_segments"] >= 2 and all(w <= 3.0 for w in got[1]["long_form_window_seconds"])
    assert got[2]["vad_segments"] == 1


def test_long_recordings_take_the_long_form_path_by_default(engines, monkeypatch):
    """Routing by duration (``LONG_FORM_THRESHOLD_SECONDS``, 120 s), with the
    threshold lowered so that a 6 s recording stands for a long one; an
    explicit ``long_form: false`` keeps the short path."""
    assert port_server.LONG_FORM_THRESHOLD_SECONDS == LONG_FORM_THRESHOLD_SECONDS
    monkeypatch.setattr(port_server, "LONG_FORM_THRESHOLD_SECONDS", 5.0)
    _ref, port = engines()
    got = _serve(port, [_transcribe(1, _recording()), _transcribe(2, _recording(), long_form=False),
                        _transcribe(3, speechlike(2.0, seed=5))])
    assert got[1]["long_form"] is True and "long_form" not in got[2] and "long_form" not in got[3]
    assert all(r["success"] for r in got.values())

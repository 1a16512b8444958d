"""The engine's host spans (``light_whisper_tpu_torch/runtime/tracing.py``) on the CPU.

- The aggregates count and sum every span of many threads.
- With no profiler running a span opens no profiler range; under a profiler
  that records every thread, spans opened on a worker thread appear under
  their names with their request ids.
- The wire, scheduler and long-form layers stay plain Python: importing them
  (and the tracer) imports no torch.
- Through ``Qwen3EngineServer`` on a threaded ``EngineServer`` over OS pipes,
  with a tiny model: one named-stream request, two coalesced fresh streams
  (the batched fresh tick), the same two extended (the batched segment tick),
  the first stream extended (the segment tick), then with sessions off one
  request (the stateless ``transcribe``) and two coalesced ones
  (``transcribe_batch``). Every path takes one ``model.encode`` and one
  ``model.prefill``; each decode step is one ``model.decode.step`` span whose
  wall is the step list's entry, holding one ``model.decode.sync`` no longer
  than itself; each job is one ``scheduler.queue``; each transcribe command
  one of each ``wire.*`` span; a reply's ``vad_ms`` is its ``vad`` span's
  wall; and ``stats`` reports the same aggregates.
"""

import base64
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu_torch.eval.speechlike import speechlike
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.runtime import tracing
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer
from light_whisper_tpu_torch.runtime.server import EngineServer

MAX_NEW = 6
WIRE = ("wire.parse", "wire.pool_wait", "wire.audio", "wire.reply")


class SpanLog(tracing.Spans):
    """The aggregates, and every span as it closes: (name, seconds, request
    ids of its thread, thread)."""

    def __init__(self):
        super().__init__()
        self.entries = []

    def add(self, name, seconds):
        self.entries.append((name, seconds, tracing.current_requests(), threading.get_ident()))
        super().add(name, seconds)

    def named(self, name, since=0):
        return [e for e in self.entries[since:] if e[0] == name]


def test_aggregates_count_and_sum_across_threads(monkeypatch):
    monkeypatch.setattr(tracing, "_SPANS", tracing.Spans())
    threads_n, per_thread = max(8, (os.cpu_count() or 1) + 1), 300
    walls = [[] for _ in range(threads_n)]
    start = threading.Barrier(threads_n)

    def work(i):
        start.wait(10)
        for _ in range(per_thread):
            with tracing.span("test.span") as s:
                pass
            walls[i].append(s.seconds)
            tracing.record("test.record", 0.002)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = tracing.snapshot()
    assert snap["test.span"]["count"] == snap["test.record"]["count"] == threads_n * per_thread
    assert snap["test.record"]["total_ms"] == pytest.approx(threads_n * per_thread * 2.0)
    assert snap["test.span"]["total_ms"] == pytest.approx(1000.0 * sum(map(sum, walls)), abs=2e-3)


def test_with_the_profiler_off_a_span_opens_no_range(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    opened = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function", lambda *a: opened.append(a))
    with tracing.requests((5,)), tracing.span("test.off") as s:
        pass
    assert opened == [] and s.seconds >= 0.0


def test_spans_of_a_worker_thread_reach_a_profiler_of_every_thread():
    def work():
        with tracing.requests((7, 8)), tracing.span("test.outer"):
            with tracing.requests((9,)), tracing.span("test.inner"):
                torch.ones(4).sum()

    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], experimental_config=config) as prof:
        worker = threading.Thread(target=work)
        worker.start()
        worker.join(30)
    assert not worker.is_alive()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert "test.outer[7,8]" in events and "test.inner[9]" in events
    outer, inner = events["test.outer[7,8]"], events["test.inner[9]"]
    assert outer.start_thread_id() == inner.start_thread_id()
    assert outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()


@pytest.mark.parametrize("module", ["runtime.tracing", "runtime.server", "serving.scheduler", "serving.longform"])
def test_the_plain_python_layers_import_no_torch(module):
    code = f"import sys, light_whisper_tpu_torch.{module}; sys.exit('torch' in sys.modules)"
    assert subprocess.run([sys.executable, "-c", code], timeout=60).returncode == 0


# -- through the engine ------------------------------------------------------


class FullSpanVad:
    def speech_timestamps(self, audio):
        return [{"start": 0, "end": len(audio)}]

    def warmup(self):
        pass


def _b64(audio):
    pcm = np.clip(np.round(np.asarray(audio) * 32767.0), -32768, 32767).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode()


def _transcribe(rid, audio, stream=None):
    cmd = {"action": "transcribe", "request_id": rid, "audio_base64": _b64(audio), "audio_format": "pcm_s16le",
           "sample_rate": 16000}
    if stream:
        cmd["options"] = {"stream": stream}
    return cmd


class Conversation:
    """A threaded ``EngineServer`` over OS pipes."""

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
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _coalesced(engine, conv, cmds):
    """``cmds`` queued behind a busy scheduler, so they run as one dispatch."""
    scheduler = engine._decode_scheduler()
    running, release = threading.Event(), threading.Event()
    scheduler.submit("blocker", lambda: (running.set(), release.wait(60)), supersede=False)
    assert running.wait(30)
    for cmd in cmds:
        conv.send(cmd)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with scheduler._lock:
            if len(scheduler._queue) >= len(cmds):
                break
        time.sleep(0.005)
    release.set()
    return [conv.recv() for _ in cmds]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every path's replies, with the spans logged from the first request on
    and each path's step list."""
    path = str(tmp_path_factory.mktemp("tracing") / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=5)
    mp = pytest.MonkeyPatch()
    mp.delenv("LIGHT_WHISPER_DISABLE_SESSION_REUSE", raising=False)
    log = SpanLog()
    try:
        engine = Qwen3EngineServer(model_path=path, device="cpu", vad_factory=FullSpanVad,
                                   model_factory=lambda p: Qwen3ASRModel(p, device="cpu", max_new_tokens=MAX_NEW))
        conv = Conversation(engine)
        assert conv.recv()["success"]  # init, its warm-up included, before the log
        mp.setattr(tracing, "_SPANS", log)
        clips = {s: speechlike(2.0, seed=seed) for s, seed in (("a", 31), ("b", 32), ("c", 33))}
        grown = {s: np.concatenate([c, c[:8000]]) for s, c in clips.items()}
        bridge = lambda s: engine._session_pool._bridges[s]._inc  # noqa: E731
        phases = []  # (name, first log index, replies, step list, dispatches, jobs)

        def phase(name, run, steps, dispatches, jobs):
            since = len(log.entries)
            replies = run()
            phases.append((name, since, len(log.entries), replies, list(steps()), dispatches, jobs))

        def one(cmd):
            conv.send(cmd)
            return [conv.recv()]

        phase("session full prefill", lambda: one(_transcribe(1, clips["a"], "a")),
              lambda: bridge("a").last_decode_step_s, 1, 1)
        phase("batched fresh tick", lambda: _coalesced(engine, conv, [_transcribe(2, clips["b"], "b"),
                                                                      _transcribe(3, clips["c"], "c")]),
              lambda: bridge("b").last_decode_step_s, 2, 3)
        phase("batched segment tick", lambda: _coalesced(engine, conv, [_transcribe(4, grown["b"], "b"),
                                                                        _transcribe(5, grown["c"], "c")]),
              lambda: bridge("b").last_decode_step_s, 2, 3)
        phase("segment tick", lambda: one(_transcribe(6, grown["a"], "a")),
              lambda: bridge("a").last_decode_step_s, 1, 1)
        mp.setenv("LIGHT_WHISPER_DISABLE_SESSION_REUSE", "1")
        phase("stateless transcribe", lambda: one(_transcribe(7, clips["a"])),
              lambda: engine.model.last_decode_step_s, 1, 1)
        phase("stateless batch", lambda: _coalesced(engine, conv, [_transcribe(8, clips["b"]),
                                                                   _transcribe(9, clips["c"])]),
              lambda: engine.model.last_decode_step_s, 2, 3)
        conv.send({"action": "stats", "request_id": 99})
        stats = conv.recv()["stats"]
        counters = {"clip_guard": sum(t._inc.clip_guard_prefills for t in engine._session_pool._bridges.values()),
                    "degrades": stats["batched_tick_degrades"], "tick_dispatches": stats["batched_tick_dispatches"]}
        conv.close()
    finally:
        mp.undo()
    return log, phases, stats, counters


def test_every_path_ran_as_intended(served):
    _log, phases, _stats, counters = served
    assert all(r["success"] and r["vad_segments"] == 1 for p in phases for r in p[3])
    assert counters == {"clip_guard": 0, "degrades": 0, "tick_dispatches": 2}


@pytest.mark.parametrize("index", range(6))
def test_each_path_takes_one_encode_and_one_prefill_under_its_requests(served, index):
    log, phases, _stats, _counters = served
    name, lo, hi, replies, _steps, _dispatches, _jobs = phases[index]
    rids = {r["request_id"] for r in replies}
    for span in ("model.encode", "model.prefill"):
        entries = [e for e in log.entries[lo:hi] if e[0] == span]
        assert len(entries) == 1, (name, span)
        assert set(entries[0][2]) == rids, (name, span)


@pytest.mark.parametrize("index", range(6))
def test_a_step_span_is_the_step_lists_entry_and_holds_one_shorter_sync(served, index):
    log, phases, _stats, _counters = served
    name, lo, hi, _replies, steps, _dispatches, _jobs = phases[index]
    entries = [e for e in log.entries[lo:hi] if e[0] in ("model.decode.step", "model.decode.sync")]
    step_walls = [e[1] for e in entries if e[0] == "model.decode.step"]
    assert step_walls == steps and len(steps) > 0, name
    # spans nest: each step closes right after its one sync, on its thread
    assert [e[0] for e in entries] == ["model.decode.sync", "model.decode.step"] * len(steps), name
    for sync, step in zip(entries[::2], entries[1::2]):
        assert sync[3] == step[3] and sync[1] <= step[1]


def test_the_scheduler_records_each_job_and_dispatch(served):
    log, phases, _stats, _counters = served
    assert len(log.named("scheduler.queue")) == sum(p[6] for p in phases)
    assert len(log.named("scheduler.dispatch")) == sum(p[5] for p in phases)


def test_wire_spans_count_the_transcribe_commands(served):
    log, phases, _stats, _counters = served
    rids = sorted(r["request_id"] for p in phases for r in p[3])
    for span in WIRE:
        assert len(log.named(span)) == len(rids), span
    for span in ("wire.audio", "wire.reply"):
        assert sorted(e[2][0] for e in log.named(span)) == rids, span


def test_a_replys_vad_ms_is_its_vad_span(served):
    log, phases, _stats, _counters = served
    walls = {e[2]: e[1] for e in log.named("vad")}
    for reply in (r for p in phases for r in p[3]):
        assert reply["vad_ms"] == round(walls[(reply["request_id"],)] * 1000, 3)


def test_stats_reports_the_aggregates(served):
    log, _phases, stats, _counters = served
    spans = stats["spans"]
    names = {e[0] for e in log.entries}
    assert {"vad", "model.encode", "model.prefill", "model.decode.step", "model.decode.sync", "scheduler.queue",
            "scheduler.dispatch", *WIRE} <= names
    for name in names - {"wire.reply"}:  # the stats reply may precede the last reply span's close
        assert spans[name]["count"] == len(log.named(name)), name
        assert spans[name]["total_ms"] == pytest.approx(1000 * sum(e[1] for e in log.named(name)), abs=1e-2)

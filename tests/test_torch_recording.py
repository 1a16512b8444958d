"""The port's recording stack against the reference's, on the host.

The reference's own cases for the capture ring, the downmix, the waveform
bars, the recording controller (a fake transcriber, real threads) and the
recording state machine (``tests/test_recording.py``,
``tests/test_recording_state.py``) run as cases over both packages, so that
the port is held to the same behaviour. Then the pure-host copies against
their originals on the same inputs: ``adapt_interval`` and
``StablePrefixTracker`` on seeded random strings, ``StreamingResampler``
bitwise over seeded chunkings at 44.1 and 48 kHz, and ``encode_wav_mono_s16``
byte for byte.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

SR = 16_000
PACKAGES = ("light_whisper_tpu", "light_whisper_tpu_torch")


def _stack(package):
    mod = lambda name: importlib.import_module(f"{package}.{name}")  # noqa: E731
    return SimpleNamespace(capture=mod("audio.capture"), pcm=mod("audio.pcm"), recording=mod("runtime.recording"),
                           state=mod("runtime.recording_state"), streaming=mod("serving.streaming"),
                           prefix=mod("text.prefix"))


@pytest.fixture(params=PACKAGES, ids=["reference", "port"])
def stack(request):
    return _stack(request.param)


@pytest.fixture(scope="module")
def both():
    return _stack(PACKAGES[0]), _stack(PACKAGES[1])


# -- downmix and ring (tests/test_recording.py) -------------------------------------


def test_mix_to_mono_formats(stack):
    mix = stack.capture.mix_to_mono
    x = np.array([1, -2, 3], dtype=np.int16)
    assert np.array_equal(mix(x), x)
    out = mix(np.array([0.5, -1.5, 1.0], dtype=np.float32))
    assert out.dtype == np.int16 and out.tolist() == [round(0.5 * 32767), -32767, 32767]
    assert mix(np.array([32768, 0, 65535], dtype=np.uint16)).tolist() == [0, -32768, 32767]
    assert mix(np.array([1000, 3000, -1000, -3000], dtype=np.int16), channels=2).tolist() == [2000, -2000]
    assert mix(np.array([[1000, 3000], [-1000, -3000]], dtype=np.int16)).tolist() == [2000, -2000]
    with pytest.raises(TypeError):
        mix(np.zeros(4, dtype=np.int32))


def test_capture_ring_appends_and_caps(stack):
    ring = stack.capture.CaptureRing(SR)
    ring.append(np.array([1, 2], dtype=np.int16))
    ring.append(np.array([3], dtype=np.int16))
    assert len(ring) == 3 and ring.snapshot().tolist() == [1, 2, 3] and ring.delta_since(2).tolist() == [3]
    capped = stack.capture.CaptureRing(sample_rate=2)  # cap = 30*60*2 = 3600 samples
    assert capped.append(np.zeros(3000, dtype=np.int16)) == 3000
    assert capped.append(np.ones(1000, dtype=np.int16)) == 600
    assert capped.append(np.ones(10, dtype=np.int16)) == 0 and len(capped) == 3600


def test_scripted_source_feeds_ring_through_downmix(stack):
    cap = stack.capture
    ring = cap.CaptureRing(SR)
    src = cap.ScriptedSource([np.full(100, 0.5, dtype=np.float32), np.full(60, -0.25, dtype=np.float32)],
                             sample_rate=SR)
    handle = cap.start_capture(src, ring)
    deadline = time.time() + 5
    while not src.drained() and time.time() < deadline:
        time.sleep(0.01)
    handle.stop()
    snap = ring.snapshot()
    assert len(snap) == 160 and snap[0] == round(0.5 * 32767) and snap[-1] == round(-0.25 * 32767)


def test_waveform_bars_and_emitter(stack):
    cap = stack.capture
    assert cap.waveform_bars(np.zeros(0, dtype=np.int16)) == [0.0] * 9
    assert cap.waveform_bars(np.zeros(900, dtype=np.int16)) == [0.0] * 9
    x = np.zeros(9000, dtype=np.int16)
    x[:4500] = 32767
    bars = cap.waveform_bars(x)
    assert len(bars) == 9 and bars[0] > 0.99 and bars[-1] == 0.0
    ring = cap.CaptureRing(SR)
    ring.append((np.ones(SR) * 16384).astype(np.int16))
    got = []
    emitter = cap.WaveformEmitter(ring, got.append, interval_ms=20)
    emitter.start()
    time.sleep(0.15)
    emitter.stop()
    assert len(got) >= 2 and all(len(b) == 9 for b in got)
    assert got[-1][-1] == pytest.approx(0.5, abs=0.01)


def test_capture_ring_delta_and_tail_cross_chunk_boundaries(stack):
    ring = stack.capture.CaptureRing(SR)
    for lo, hi in ((0, 5), (5, 9), (9, 12)):
        ring.append(np.arange(lo, hi, dtype=np.int16))
    for offset in (0, 3, 5, 11):
        assert np.array_equal(ring.delta_since(offset), np.arange(offset, 12, dtype=np.int16))
    assert len(ring.delta_since(12)) == 0
    assert ring.tail(4).tolist() == [8, 9, 10, 11] and ring.tail(100).tolist() == list(range(12))
    assert len(ring.tail(0)) == 0
    d = ring.delta_since(9)
    d[:] = 0  # a copy: the ring is untouched
    assert ring.delta_since(9).tolist() == [9, 10, 11]


def test_capture_ring_owns_appended_data(stack):
    ring = stack.capture.CaptureRing(SR)
    buf = np.arange(10, dtype=np.int16)
    ring.append(buf)
    buf[:] = -1  # a device backend reuses its callback buffer
    assert ring.snapshot().tolist() == list(range(10))


def test_capture_ring_tail_fuzz_matches_snapshot_slices(stack):
    rng = np.random.default_rng(11)
    ring = stack.capture.CaptureRing(SR)
    for _ in range(37):
        ring.append(rng.integers(-100, 100, size=int(rng.integers(1, 50)), dtype=np.int16))
    snap = ring.snapshot()
    for offset in [0, 1, 7, 100, len(snap) - 1, len(snap), len(snap) + 5]:
        np.testing.assert_array_equal(ring.delta_since(offset), snap[offset:])
    for n in [0, 1, 13, 200, len(snap), len(snap) + 9]:
        np.testing.assert_array_equal(ring.tail(n), snap[len(snap) - min(n, len(snap)):])


# -- the recording controller with a fake transcriber (tests/test_recording.py) -----


class FakeTranscriber:
    """Deterministic stand-in: the text encodes the audio length it saw."""

    def __init__(self):
        self.calls = []

    def transcribe(self, audio):
        self.calls.append(len(np.asarray(audio)))
        return SimpleNamespace(text=f"len={len(np.asarray(audio))}", language="zh")


def _float_blocks(seconds, block_s=0.25):
    audio = (np.random.default_rng(3).standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)
    n = int(block_s * SR)
    return [audio[i : i + n] for i in range(0, len(audio), n)]


def _drain(src, seconds=5):
    deadline = time.time() + seconds
    while not src.drained() and time.time() < deadline:
        time.sleep(0.01)


def test_recording_end_to_end_interim_reuse(stack):
    ctl = stack.recording.RecordingController(FakeTranscriber())
    interims = []
    src = stack.capture.ScriptedSource(_float_blocks(2.0), sample_rate=SR)
    sid = ctl.start_recording(src, on_interim=interims.append, interval_scale=0.05)
    assert ctl.state.snapshot().phase == stack.state.RecordingPhase.RECORDING
    deadline = time.time() + 10
    while (not interims or not src.drained()) and time.time() < deadline:
        time.sleep(0.02)
    time.sleep(0.1)  # one more tick covers the tail
    result = ctl.stop_recording()
    assert isinstance(result, stack.recording.RecordingResult) and result.session_id == sid
    assert not result.too_short and result.duration_seconds == pytest.approx(2.0, abs=0.01)
    assert result.interim_ticks >= 1 and interims
    assert result.from_interim_cache and result.text == interims[-1].text  # 2 s fits, tail gap 0
    assert ctl.state.snapshot() is None


def test_recording_too_short_outcome(stack):
    t = FakeTranscriber()
    ctl = stack.recording.RecordingController(t)
    src = stack.capture.ScriptedSource([np.zeros(int(0.3 * SR), dtype=np.float32)], sample_rate=SR)
    ctl.start_recording(src, interval_scale=10.0)
    _drain(src)
    result = ctl.stop_recording()
    assert result.too_short and result.text == ""
    snap = ctl.state.snapshot()
    assert snap.phase == stack.state.RecordingPhase.OUTCOME and snap.outcome.value == "too_short"
    assert not t.calls


def test_recording_finalize_without_interim_runs_full_asr(stack):
    t = FakeTranscriber()
    ctl = stack.recording.RecordingController(t)
    src = stack.capture.ScriptedSource(_float_blocks(1.0), sample_rate=SR)
    ctl.start_recording(src, interval_scale=50.0)
    _drain(src)
    result = ctl.stop_recording()
    assert not result.from_interim_cache and result.text == f"len={SR}" and t.calls == [SR]


def test_recording_resamples_foreign_rate_sources(stack):
    t = FakeTranscriber()
    ctl = stack.recording.RecordingController(t)
    block = np.zeros(48_000, dtype=np.float32)
    block[:24_000] = 0.4
    src = stack.capture.ScriptedSource([block], sample_rate=48_000)
    ctl.start_recording(src, sample_rate=48_000, interval_scale=50.0)
    _drain(src)
    result = ctl.stop_recording()
    assert result.duration_seconds == pytest.approx(1.0, abs=0.01)
    assert t.calls and t.calls[0] == pytest.approx(SR, abs=2)


def test_recording_cancel_discards_without_asr(stack):
    t = FakeTranscriber()
    ctl = stack.recording.RecordingController(t)
    sid = ctl.start_recording(stack.capture.ScriptedSource(_float_blocks(1.0), sample_rate=SR), interval_scale=50.0)
    ctl.cancel_recording()
    assert not t.calls
    assert ctl.state.snapshot() is None or ctl.state.snapshot().session_id != sid
    src2 = stack.capture.ScriptedSource(_float_blocks(1.0), sample_rate=SR)
    ctl.start_recording(src2, interval_scale=50.0)  # reusable after a cancel
    _drain(src2)
    assert not ctl.stop_recording().too_short


def test_second_start_rejected_while_active(stack):
    ctl = stack.recording.RecordingController(FakeTranscriber())
    ctl.start_recording(stack.capture.ScriptedSource(_float_blocks(1.0), sample_rate=SR), interval_scale=50.0)
    with pytest.raises(RuntimeError, match="already active"):
        ctl.start_recording(stack.capture.ScriptedSource([], sample_rate=SR))
    ctl.cancel_recording()


def test_recording_waveform_bars_emitted(stack):
    ctl = stack.recording.RecordingController(FakeTranscriber())
    bars = []
    blocks = [np.full(int(0.2 * SR), 0.5, dtype=np.float32) for _ in range(5)]
    src = stack.capture.ScriptedSource(blocks, sample_rate=SR, realtime=True)
    ctl.start_recording(src, on_waveform=bars.append, interval_scale=50.0)
    time.sleep(0.3)
    ctl.stop_recording()
    assert bars and all(len(b) == 9 for b in bars) and max(max(b) for b in bars) > 0.4


def test_interim_tick_errors_do_not_kill_the_loop(stack):
    class FlakyTranscriber:
        def __init__(self):
            self.calls = 0

        def transcribe(self, audio):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("engine restarting")
            return SimpleNamespace(text=f"n={len(audio)}", language="zh")

    ctl = stack.recording.RecordingController(FlakyTranscriber())
    src = stack.capture.ScriptedSource([np.full(SR // 10, 0.1, dtype=np.float32)] * 10, sample_rate=SR)
    ctl.start_recording(src, on_interim=lambda r: None, interval_scale=2.0)
    deadline = time.time() + 10
    while time.time() < deadline:
        active = ctl._active
        if active is not None and active.tick_errors >= 1 and active.ticks >= 1:
            break
        time.sleep(0.02)
    result = ctl.stop_recording()
    assert result.text.startswith("n=") and not result.too_short


def test_finalize_waits_for_a_tick_that_outlives_the_join(stack, monkeypatch):
    """A tick longer than the bounded join: finalize takes the session lock
    after the join times out, so it runs after the tick, never beside it.
    13 s of audio outgrow the 12 s window, so finalize transcribes."""
    monkeypatch.setattr(stack.recording, "INTERIM_JOIN_TIMEOUT_S", 0.05)
    ticking, log = threading.Event(), []

    class SlowTicks:
        def transcribe_window(self, window, window_start_sample=0):
            log.append("tick")
            ticking.set()
            time.sleep(0.5)
            log.append("tick done")
            return SimpleNamespace(text="tick", language="zh")

        def transcribe(self, audio):
            log.append("final")
            return SimpleNamespace(text=f"n={len(audio)}", language="zh")

    ctl = stack.recording.RecordingController(SlowTicks())
    src = stack.capture.ScriptedSource(_float_blocks(13.0), sample_rate=SR)
    ctl.start_recording(src, interval_scale=0.05)
    assert ticking.wait(10)
    _drain(src)
    result = ctl.stop_recording()
    assert log == ["tick", "tick done", "final"]
    assert result.text == f"n={13 * SR}" and not result.from_interim_cache


# -- the recording state machine (tests/test_recording_state.py) ----------------------


def test_phase_progression_mints_increasing_revisions(stack):
    st = stack.state
    state = st.RecordingSessionState()
    sid = state.begin_session("dictation")
    revisions = [state.snapshot().revision]
    for phase in (st.RecordingPhase.RECORDING, st.RecordingPhase.PROCESSING, st.RecordingPhase.OUTCOME):
        outcome = st.RecordingOutcomeKind.NO_SPEECH if phase == st.RecordingPhase.OUTCOME else None
        snap = state.transition_if_current(sid, phase, "dictation", outcome=outcome)
        assert snap is not None
        revisions.append(snap.revision)
    assert revisions == sorted(revisions) and len(set(revisions)) == len(revisions)
    assert state.snapshot().phase == st.RecordingPhase.OUTCOME
    assert state.snapshot().outcome == st.RecordingOutcomeKind.NO_SPEECH


def test_stale_session_transition_rejected(stack):
    st = stack.state
    state = st.RecordingSessionState()
    old = state.begin_session()
    new = state.begin_session("assistant")
    assert state.transition_if_current(old, st.RecordingPhase.PROCESSING, "dictation") is None
    assert state.snapshot().session_id == new
    assert state.transition_if_current(new, st.RecordingPhase.RECORDING, "assistant") is not None


def test_outcome_detail_only_on_outcome_phase(stack):
    st = stack.state
    state = st.RecordingSessionState()
    sid = state.begin_session()
    snap = state.transition_if_current(sid, st.RecordingPhase.PROCESSING, "dictation",
                                       outcome=st.RecordingOutcomeKind.ASR_ERROR, detail="ignored")
    assert snap.outcome is None and snap.detail is None
    done = state.transition_if_current(sid, st.RecordingPhase.OUTCOME, "dictation",
                                       outcome=st.RecordingOutcomeKind.ASR_ERROR, detail="engine crashed")
    assert done.outcome == st.RecordingOutcomeKind.ASR_ERROR and done.detail == "engine crashed"
    event = done.to_event()
    assert event["outcome"] == "asr_error" and event["phase"] == "outcome"


def test_clear_is_session_gated(stack):
    state = stack.state.RecordingSessionState()
    old = state.begin_session()
    new = state.begin_session()
    assert not state.clear_if_session(old) and state.snapshot() is not None
    assert state.clear_if_session(new) and state.snapshot() is None


def test_concurrent_transitions_keep_revisions_strict(stack):
    state = stack.state.RecordingSessionState()
    sid = state.begin_session()
    seen, lock = [], threading.Lock()

    def hammer():
        for _ in range(200):
            snap = state.transition_if_current(sid, stack.state.RecordingPhase.RECORDING, "dictation")
            if snap is not None:
                with lock:
                    seen.append(snap.revision)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(seen) == 800 and len(set(seen)) == 800


def test_state_enums_and_events_match(both):
    ref, port = both
    for name in ("RecordingPhase", "RecordingOutcomeKind"):
        assert [(m.name, m.value) for m in getattr(port.state, name)] == [
            (m.name, m.value) for m in getattr(ref.state, name)]
    snaps = [s.state.RecordingSnapshot(3, 7, s.state.RecordingPhase.OUTCOME, "assistant",
                                       s.state.RecordingOutcomeKind.START_ERROR, "no device") for s in both]
    assert snaps[0].to_event() == snaps[1].to_event()


# -- the pure-host copies against their originals -------------------------------------


def _random_text(rng, alphabet="ab你好 .", max_len=12):
    return "".join(rng.choice(list(alphabet), size=int(rng.integers(0, max_len))))


@pytest.mark.parametrize("seed", range(4))
def test_prefix_tracker_matches_the_reference(both, seed):
    ref, port = both
    rng = np.random.default_rng(seed)
    r_tracker, p_tracker = ref.prefix.StablePrefixTracker(), port.prefix.StablePrefixTracker()
    for step in range(40):
        if step % 13 == 12:
            r_tracker.reset()
            p_tracker.reset()
        base = p_tracker.last_hypothesis
        # mostly extensions of the last hypothesis, sometimes a rewrite of its tail
        text = base[: int(rng.integers(0, len(base) + 1))] + _random_text(rng) if rng.random() < 0.7 \
            else _random_text(rng)
        got = p_tracker.update(text)
        assert tuple(got) == tuple(r_tracker.update(text))
        assert got.stable + got.tentative == text
        assert p_tracker.last_hypothesis == r_tracker.last_hypothesis
        other = _random_text(rng)
        assert port.prefix.common_prefix_len(text, other) == ref.prefix.common_prefix_len(text, other)
        assert tuple(port.prefix.interim_segments(other, text)) == tuple(ref.prefix.interim_segments(other, text))


def test_adapt_interval_and_constants_match_the_reference(both):
    ref, port = both
    names = ("SAMPLE_RATE", "MAX_BUFFER_SAMPLES", "WINDOW_SECONDS", "MIN_FIRST_TICK_SECONDS",
             "FINALIZE_REUSE_TAIL_GAP_SECONDS", "INTERVAL_BASE_MS", "INTERVAL_MIN_MS", "INTERVAL_MAX_MS",
             "INTERVAL_STEP_UP_MS", "INTERVAL_STEP_DOWN_MS", "TICK_HEAVY_MS", "TICK_LIGHT_MS")
    assert [getattr(port.streaming, n) for n in names] == [getattr(ref.streaming, n) for n in names]
    rng = np.random.default_rng(7)
    interval = ref.streaming.INTERVAL_BASE_MS
    costs = list(rng.uniform(0, 900, size=300)) + [180, 180.0001, 419.999, 420, 0, 2000]
    for cost in costs:
        got = port.streaming.adapt_interval(interval, cost)
        assert got == ref.streaming.adapt_interval(interval, cost)
        interval = got
    for current in range(100, 520, 7):
        for cost in (0.0, 180.0, 300.0, 420.0, 5000.0):
            assert port.streaming.adapt_interval(current, cost) == ref.streaming.adapt_interval(current, cost)


def test_streaming_session_windows_match_the_reference(both):
    """The window (and its aligned start) each tick hands the transcriber,
    with a buffer growing past the 12 s window, and the finalize decision."""
    seen = {}

    class Recorder:
        def __init__(self, key):
            self.key = key

        def transcribe_window(self, window, window_start_sample=0):
            seen.setdefault(self.key, []).append((len(window), window_start_sample, float(np.sum(window))))
            return SimpleNamespace(text=f"w{len(window)}", language="en")

        def transcribe(self, audio):
            seen.setdefault(self.key, []).append((len(audio), "full", float(np.sum(audio))))
            return SimpleNamespace(text=f"f{len(audio)}", language="en")

    rng = np.random.default_rng(9)
    sessions = [s.streaming.StreamingSession(Recorder(i)) for i, s in enumerate(both)]
    results = [[], []]
    for step in range(30):
        block = rng.standard_normal(int(rng.integers(1000, 16000))).astype(np.float32)
        for i, session in enumerate(sessions):
            session.accept(block)
            if step % 3 != 1:
                r = session.tick()
                results[i].append(None if r is None else (r.text, r.stable, r.tentative, r.covered_samples))
    assert seen[0] == seen[1] and results[0] == results[1]
    assert any(start not in (0, "full") for _n, start, _s in seen[1])  # the window slid
    finals = [s.finalize() for s in sessions]
    assert (finals[1].text, finals[1].language, finals[1].from_interim_cache) == (
        finals[0].text, finals[0].language, finals[0].from_interim_cache)


@pytest.mark.parametrize("rate", [44_100, 48_000])
@pytest.mark.parametrize("seed", range(3))
def test_streaming_resampler_is_bitwise_the_reference(both, rate, seed):
    ref, port = both
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal(rate * 2).astype(np.float32)
    cuts = np.sort(rng.integers(0, len(audio), size=int(rng.integers(3, 40))))
    r_res, p_res = ref.pcm.StreamingResampler(rate), port.pcm.StreamingResampler(rate)
    outs = []
    for chunk in np.split(audio, cuts):
        got, want = p_res.push(chunk), r_res.push(chunk)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        outs.append(got)
    whole = port.pcm.StreamingResampler(rate).push(audio)
    assert np.concatenate(outs).tobytes() == whole.tobytes()  # phase-continuous
    with pytest.raises(ValueError):
        port.pcm.StreamingResampler(0)


@pytest.mark.parametrize("rate", [16_000, 44_100])
def test_encode_wav_is_byte_for_byte_the_reference(both, rate):
    ref, port = both
    rng = np.random.default_rng(rate)
    samples = np.concatenate([rng.uniform(-1.2, 1.2, 5000), [1.0, -1.0, 0.0, 0.99999]]).astype(np.float32)
    got = port.pcm.encode_wav_mono_s16(samples, rate)
    assert got == ref.pcm.encode_wav_mono_s16(samples, rate)
    pcm16 = rng.integers(-32768, 32767, 777).astype(np.int16)
    assert port.pcm.encode_wav_mono_pcm16(pcm16, rate) == ref.pcm.encode_wav_mono_pcm16(pcm16, rate)

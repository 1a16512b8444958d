"""The port's batched interim ticks (``serving/incremental_batch.py``) against
the reference's ``tick_batch`` and against sequential per-stream ticks.

On the tiny GGUF fixture the same streams tick through both packages'
``tick_batch`` (tokens and the five session counters identical) and through
the port's per-stream ``IncrementalTranscriber`` (tokens identical, or parted
only inside the 1e-3 top-2 tie band, the gap printed). Mixed groups —
extending and fresh sessions, mismatched buckets, a clip-guard redo — take
the reference's routes; a forced failure of the batched runner raises
``degrade_count`` while every stream keeps its result.
"""

import numpy as np
import pytest

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
from light_whisper_tpu.serving import incremental_batch as ref_ib
from light_whisper_tpu.serving.incremental import IncrementalTranscriber as RefInc
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.serving import incremental_batch as ib
from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber

SR = 16000
MAX_NEW = 8
TIE_BAND = 1e-3
COUNTERS = ("full_prefills", "incremental_prefills", "clip_guard_prefills", "draft_tokens_offered",
            "draft_tokens_accepted")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")
    path = str(tmp_path_factory.mktemp("tickb") / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=0)
    try:
        yield RefModel(path, max_new_tokens=MAX_NEW), Qwen3ASRModel(path, device="cpu", max_new_tokens=MAX_NEW)
    finally:
        mp.undo()


@pytest.fixture
def runs(monkeypatch):
    """Counts the batched runners' calls (number of streams each)."""
    seen = {"group": [], "fresh": []}
    real_group, real_fresh = ib._run_group, ib._run_group_fresh
    monkeypatch.setattr(ib, "_run_group", lambda plans: seen["group"].append(len(plans)) or real_group(plans))
    monkeypatch.setattr(ib, "_run_group_fresh",
                        lambda plans: seen["fresh"].append(len(plans)) or real_fresh(plans))
    return seen


def _noise(seconds, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(int(seconds * SR)) * scale).astype(np.float32)


def _counters(inc):
    return {name: getattr(inc, name) for name in COUNTERS}


def _same_or_tie(port, window, got, want):
    if got == want:
        return
    step = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), min(len(want), len(got)))
    logits = port.teacher_forced_logits(window, want[:step])[step].numpy()[: port.config.decoder.vocab_size]
    top2 = np.sort(logits)[-2:]
    gap = float(top2[1] - top2[0])
    print(f"batched tick parts from the per-stream tick at step {step}: top-2 gap {gap:.3g}")
    assert gap <= TIE_BAND, (step, gap, want, got)


def _tick_all(models, rounds, window_starts=None):
    """Each round's windows through both packages' tick_batch and the port's
    sequential ticks; returns the port's batched transcribers."""
    ref, port = models
    n = len(rounds[0])
    r_incs = [RefInc(ref, max_new_tokens=MAX_NEW) for _ in range(n)]
    p_incs = [IncrementalTranscriber(port, max_new_tokens=MAX_NEW) for _ in range(n)]
    s_incs = [IncrementalTranscriber(port, max_new_tokens=MAX_NEW) for _ in range(n)]
    for k, windows in enumerate(rounds):
        starts = window_starts[k] if window_starts else [0] * n
        want = ref_ib.tick_batch(r_incs, windows, starts)
        got = ib.tick_batch(p_incs, windows, starts)
        for b in range(n):
            assert got[b].tokens == want[b].tokens, (k, b)
            assert _counters(p_incs[b]) == _counters(r_incs[b]), (k, b)
            solo = s_incs[b].transcribe_window(windows[b], window_start_sample=starts[b])
            _same_or_tie(port, windows[b], got[b].tokens, solo.tokens)
    return p_incs


def test_extending_streams_batch_and_match(models, runs):
    audios = [_noise(7, seed=s) for s in range(3)]
    incs = _tick_all(models, [[a[: s * SR] for a in audios] for s in (3, 5, 7)])
    assert runs["group"] and all(n == 3 for n in runs["group"]), runs
    assert all(inc.incremental_prefills >= 1 for inc in incs)


def test_fresh_streams_prime_their_sessions_in_one_batch(models, runs):
    audios = [_noise(5, seed=10 + s) for s in range(2)]
    incs = _tick_all(models, [[a[: 3 * SR] for a in audios], [a[: 5 * SR] for a in audios]])
    assert runs["fresh"] == [2] and runs["group"] == [2]
    assert all(inc.full_prefills == 1 and inc.incremental_prefills == 1 for inc in incs)


def test_mixed_groups_take_the_reference_routes(models, runs):
    """One extending stream alone in its group (per stream), two fresh ones in
    one bucket (batched fresh), one fresh one in another bucket (per stream),
    then a clip-guard redo inside a batched extending group."""
    quiet_loud = np.concatenate([_noise(5, seed=20, scale=0.002), _noise(3, seed=21, scale=0.9)])
    others = [_noise(8, seed=22 + s) for s in range(3)]
    rounds = [
        [quiet_loud[: 5 * SR], others[0][: 2 * SR], others[1][: 3 * SR], others[2][: 3 * SR]],
        [quiet_loud[: 6 * SR], others[0][: 5 * SR], others[1][: 6 * SR], others[2][: 4 * SR]],
        [quiet_loud[: 8 * SR], others[0][: 8 * SR], others[1][: 8 * SR], others[2][: 8 * SR]],
    ]
    incs = _tick_all(models, rounds)
    assert incs[0].clip_guard_prefills >= 1
    assert runs["fresh"] and runs["group"]


def test_a_window_slide_batches_fresh(models, runs):
    audios = [_noise(6, seed=30 + s) for s in range(2)]
    rounds = [[a[: 3 * SR] for a in audios], [a[SR : 4 * SR] for a in audios], [a[SR : 6 * SR] for a in audios]]
    incs = _tick_all(models, rounds, window_starts=[[0, 0], [SR, SR], [SR, SR]])
    assert runs["fresh"] == [2, 2] and runs["group"] == [2]
    assert all(inc.full_prefills == 2 for inc in incs)


def test_a_forced_batched_failure_degrades_and_every_stream_keeps_its_result(models, monkeypatch):
    _ref, port = models
    audios = [_noise(5, seed=40 + s) for s in range(2)]
    incs = [IncrementalTranscriber(port, max_new_tokens=MAX_NEW) for _ in range(2)]
    seq = [IncrementalTranscriber(port, max_new_tokens=MAX_NEW) for _ in range(2)]
    for inc, s_inc, audio in zip(incs, seq, audios):
        inc.transcribe_window(audio[: 3 * SR])
        s_inc.transcribe_window(audio[: 3 * SR])

    def boom(plans):
        raise RuntimeError("batched tick failed on purpose")

    before = ib.degrade_count
    # the module's counters are process-wide: restored after this test
    monkeypatch.setattr(ib, "degrade_count", before)
    monkeypatch.setattr(ib, "last_degrade_error", ib.last_degrade_error)
    monkeypatch.setattr(ib, "_run_group", boom)
    got = ib.tick_batch(incs, [a[: 5 * SR] for a in audios])
    assert ib.degrade_count == before + 1
    assert "failed on purpose" in ib.last_degrade_error
    for b in range(2):
        want = seq[b].transcribe_window(audios[b][: 5 * SR])
        assert got[b].tokens == want.tokens
        # the sessions were untouched: the per-stream tick still extended
        assert _counters(incs[b]) == _counters(seq[b])


def test_a_failing_stream_fails_alone(models, monkeypatch):
    _ref, port = models
    audios = [_noise(4, seed=50 + s) for s in range(3)]
    incs = [IncrementalTranscriber(port, max_new_tokens=MAX_NEW) for _ in range(3)]
    incs[1].transcribe_window = lambda *a, **k: (_ for _ in ()).throw(ValueError("stream 1 broke"))
    monkeypatch.setenv("LWT_MAX_DECODE_BATCH", "1")  # never stack: every stream ticks alone
    got = ib.tick_batch(incs, [a[: 3 * SR] for a in audios])
    assert isinstance(got[1], ValueError)
    assert got[0].tokens == port.transcribe(audios[0][: 3 * SR]).tokens
    assert got[2].tokens == port.transcribe(audios[2][: 3 * SR]).tokens


def test_bridge_batch_keeps_hits_resets_and_parks(models):
    from light_whisper_tpu_torch.serving.session_bridge import SessionBridge, transcribe_extending_batch

    _ref, port = models
    a, b = _noise(4, seed=60), _noise(4, seed=61)
    bridges = [SessionBridge(port), SessionBridge(port)]
    bridges[0].transcribe_extending(a[: 2 * SR])
    outs = transcribe_extending_batch(bridges, [a[: 3 * SR], b[: 2 * SR]])
    assert (bridges[0].session_hits, bridges[0].session_resets) == (1, 1)
    assert (bridges[1].session_hits, bridges[1].session_resets) == (0, 1)
    outs2 = transcribe_extending_batch(bridges, [a[: 4 * SR], b[: 3 * SR]])
    assert bridges[0].session_hits == 2 and bridges[1].session_hits == 1
    assert bridges[0].retained_bytes == a[: 4 * SR].nbytes
    solo = SessionBridge(port)
    for window, out in zip((a[: 2 * SR], a[: 3 * SR], a[: 4 * SR]), (None, outs[0], outs2[0])):
        want = solo.transcribe_extending(window)
        if out is not None:
            _same_or_tie(port, window, out.tokens, want.tokens)


def test_plans_match_the_reference(models):
    ref, port = models
    audio = _noise(6, seed=70)
    r_inc, p_inc = RefInc(ref, max_new_tokens=MAX_NEW), IncrementalTranscriber(port, max_new_tokens=MAX_NEW)
    r_inc.transcribe_window(audio[: 4 * SR])
    p_inc.transcribe_window(audio[: 4 * SR])
    for n in (4 * SR + 100, 5 * SR, 6 * SR):
        rp, pp = ref_ib._TickPlan(r_inc, audio[:n], 0), ib._TickPlan(p_inc, audio[:n], 0)
        for name in ("n_audio", "stable", "true_len", "draft", "bucket", "seg_bucket", "capacity"):
            assert getattr(pp, name) == getattr(rp, name), name
        assert pp.can_extend() == rp.can_extend()
        assert pp.group_key()[1:] == rp.group_key()[1:]

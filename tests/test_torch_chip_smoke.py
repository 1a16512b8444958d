"""``chip_smoke.py`` refuses to report a result without a GPU, and outside a
checkout of the repository; its narrow-model token gate holds the card to
the CPU within the 1e-3 tie band; its dictation check holds the reference's
event schema, and no child process it starts inherits
``LIGHT_WHISPER_FORCE_CPU``."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: run chip_smoke.py itself")


@pytest.mark.usefixtures("_no_gpu")
@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_fails_without_result(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], capture_output=True, text=True, cwd=os.path.dirname(script),
                          env=env, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_gate", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # imports nothing but the standard library at module level
    return module


def test_narrow_gate_passes_equal_tokens():
    assert _smoke().narrow_verdict([5, 6, 7, 8], [5, 6, 7, 8], []) is None


def test_narrow_gate_passes_a_tie_flip_followed_by_other_tokens():
    smoke = _smoke()
    assert smoke.TIE_BAND == 1e-3
    assert smoke.narrow_verdict([5, 6, 7, 8], [5, 6, 9, 2], [(2, 4e-4)]) is None


def test_narrow_gate_fails_a_flip_outside_the_tie_band():
    verdict = _smoke().narrow_verdict([5, 6, 7, 8], [5, 6, 9, 2], [(2, 5e-3)])
    assert verdict is not None and "tie band" in verdict


def test_narrow_gate_fails_tokens_that_differ_before_any_flip():
    smoke = _smoke()
    assert "no argmax flip" in smoke.narrow_verdict([5, 6, 7, 8], [5, 1, 7, 8], [])
    assert "before the first flip" in smoke.narrow_verdict([5, 6, 7, 8], [5, 1, 9, 2], [(2, 4e-4)])


def test_train_phase_holds_the_reference_training_dtypes(tmp_path):
    """``training_params`` turns the precise loader's dense f32 trees into the
    dtypes of ``__graft_entry__._random_params``, leaf for leaf."""
    import numpy as np

    import __graft_entry__ as graft
    from helpers.tiny_model import write_tiny_model

    path = str(tmp_path / "tiny.gguf")
    cfg = write_tiny_model(path, quantize=True, seed=0)
    smoke = _smoke()
    _cfg, _prefix, _suffix, enc, dec = smoke._dense_trees(path)
    want_enc, want_dec = graft._random_params(cfg, device=False)

    def dtypes(tree):
        if isinstance(tree, dict):
            return {k: dtypes(v) for k, v in tree.items() if k != "s_t"}
        return str(tree.dtype).replace("torch.", "") if isinstance(tree, torch.Tensor) else np.dtype(tree.dtype).name

    assert dtypes(smoke.training_params(enc)) == dtypes(want_enc)
    assert dtypes(smoke.training_params(dec)) == dtypes(want_dec)


def test_train_batch_labels_are_the_next_transcript_tokens(tmp_path):
    from helpers.tiny_model import write_tiny_model

    path = str(tmp_path / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=0)
    smoke = _smoke()
    cfg, prefix, suffix, _enc, _dec = smoke._dense_trees(path)
    mel, ids, labels = smoke.train_batch(torch, cfg, prefix, suffix, batch=3, seconds=2.0, labels=5, seed=1)
    chunks = mel.shape[1] // cfg.audio.chunk_frames
    assert mel.shape == (3, chunks * cfg.audio.chunk_frames, cfg.audio.num_mel_bins) and chunks == 2
    n_prompt = len(prefix) + chunks * cfg.audio.tokens_per_chunk + len(suffix)
    assert ids.shape == labels.shape == (3, n_prompt + 5)
    assert (ids[:, len(prefix):len(prefix) + chunks * cfg.audio.tokens_per_chunk] == cfg.audio_token_id).all()
    kept = labels != -100
    assert kept.sum(dim=1).tolist() == [5, 5, 5]
    assert torch.equal(labels[:, n_prompt - 1:-1], ids[:, n_prompt:])
    assert not kept[:, -1].any() and not kept[:, : n_prompt - 1].any()


def _events(ticks=2, seconds=4.0):
    interims = [{"event": "interim", "stable": "a", "tentative": "b", "covered_samples": 8000 * (i + 1),
                 "tick_ms": 500.0} for i in range(ticks)]
    final = {"event": "final", "text": "ab", "language": "unknown", "duration_seconds": seconds,
             "from_interim_cache": False, "interim_ticks": ticks, "asr_ms": 900.0, "too_short": False}
    return interims + [final]


def test_dictation_check_passes_the_reference_schema():
    smoke = _smoke()
    interims, final = smoke.check_dictation(_events(), 4.0)
    assert len(interims) == 2 and final["text"] == "ab"


@pytest.mark.parametrize("spoil", ["extra-field", "missing-final", "duration", "too-short", "tick-count",
                                   "renamed-event"])
def test_dictation_check_fails_a_spoiled_dictation(spoil):
    smoke = _smoke()
    events = _events()
    if spoil == "extra-field":
        events[-1]["device"] = "cuda"
    elif spoil == "missing-final":
        events = events[:-1]
    elif spoil == "duration":
        events[-1]["duration_seconds"] = 3.98
    elif spoil == "too-short":
        events[-1]["too_short"] = True
    elif spoil == "tick-count":
        events[-1]["interim_ticks"] = 3
    else:
        events[0]["event"] = "partial"
    with pytest.raises(smoke.PhaseError):
        smoke.check_dictation(events, 4.0)


def test_child_processes_never_inherit_force_cpu(monkeypatch):
    smoke = _smoke()
    monkeypatch.setenv("LIGHT_WHISPER_FORCE_CPU", "1")
    env = smoke._child_env(LIGHT_WHISPER_ASR_ENGINE="qwen3-asr-0.6b")
    assert "LIGHT_WHISPER_FORCE_CPU" not in env and env["LIGHT_WHISPER_ASR_ENGINE"] == "qwen3-asr-0.6b"

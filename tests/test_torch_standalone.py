"""The port stands alone: it imports nothing of the JAX package, and its own
copies of the reference's JAX-free modules behave as the originals do.

- An AST scan of every module of ``light_whisper_tpu_torch`` and of
  ``chip_smoke.py`` finds no import of ``light_whisper_tpu``, of
  ``__graft_entry__`` or of the tests' ``helpers``.
- The port's server class derives from nothing of the JAX package.
- Each copy against its original on the same inputs: GGUF reader and writer,
  tokenizer, prompt ids, VAD segmenter (and the reference's native C++
  segmenter, where it is built), PCM decode and resample, hot words, model
  cache resolution, long-form windows and speech-like audio. Where nothing is
  computed in another order the comparison is exact; the native resampler is
  compared within 1e-6 (C float arithmetic, seen at 4.8e-7).
"""

import ast
import base64
import dataclasses
import os
import pathlib
import wave

import numpy as np
import pytest

from helpers.tiny_model import tiny_config, tiny_tensors, tiny_vocab, write_tiny_model

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("light_whisper_tpu", "__graft_entry__", "helpers", "tests")


def _port_sources():
    return sorted((REPO / "light_whisper_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((alias.name, node.lineno) for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value), node.lineno


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_reference(path):
    bad = [(name, line) for name, line in _imports(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


SESSION_MODULES = ("serving/incremental.py", "serving/incremental_batch.py", "serving/session_bridge.py",
                   "serving/session_pool.py", "models/vad/api.py", "runtime/qwen3_server.py",
                   "serving/streaming.py", "text/prefix.py", "audio/capture.py", "audio/pcm.py",
                   "runtime/recording_state.py", "runtime/recording.py", "runtime/config.py",
                   "runtime/engine_cli.py")


@pytest.mark.parametrize("module", SESSION_MODULES)
def test_the_scan_covers_the_session_modules(module):
    path = REPO / "light_whisper_tpu_torch" / module
    assert path in _port_sources()
    assert {name.split(".")[0] for name, _line in _imports(path)} & set(FORBIDDEN) == set()


MULTI_DEVICE_MODULES = ("parallel/encoder_sp.py", "parallel/pipeline.py", "parallel/dryrun.py",
                        "parallel/sharding.py", "models/qwen3_asr/synthetic.py")


@pytest.mark.parametrize("module", MULTI_DEVICE_MODULES)
def test_the_scan_covers_the_multi_device_modules(module):
    path = REPO / "light_whisper_tpu_torch" / module
    assert path in _port_sources()
    assert {name.split(".")[0] for name, _line in _imports(path)} & set(FORBIDDEN) == set()


def test_the_scan_sees_every_import_form(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import light_whisper_tpu.audio\nfrom light_whisper_tpu import x\n"
                     "def f():\n    import __graft_entry__\n    from helpers.tiny_model import t\n"
                     "    importlib.import_module('light_whisper_tpu.native')\n", encoding="utf-8")
    assert [n.split(".")[0] for n, _ in _imports(probe)] == [
        "light_whisper_tpu", "light_whisper_tpu", "__graft_entry__", "helpers", "light_whisper_tpu"]


def test_server_class_has_no_reference_base():
    from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

    assert [c.__module__ for c in Qwen3EngineServer.__mro__] == [
        "light_whisper_tpu_torch.runtime.qwen3_server", "builtins"]


def test_bundled_vad_weights_are_the_reference_file():
    from light_whisper_tpu_torch.models.vad.api import BUNDLED_WEIGHTS

    ref = REPO / "light_whisper_tpu" / "models" / "vad" / "fireredvad.gguf"
    assert pathlib.Path(BUNDLED_WEIGHTS).read_bytes() == ref.read_bytes()


def _port_config(cfg):
    """The reference's config as the port's own config class."""
    from light_whisper_tpu_torch.models.qwen3_asr import config

    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("audio", "decoder")}
    return config.Qwen3ASRConfig(audio=config.AudioEncoderConfig(**dataclasses.asdict(cfg.audio)),
                                 decoder=config.DecoderConfig(**dataclasses.asdict(cfg.decoder)), **fields)


# -- GGUF -------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [True, False], ids=["q8_0", "dense"])
def test_gguf_reader_and_writer(tmp_path, quantize):
    from light_whisper_tpu.formats import gguf as ref_gguf
    from light_whisper_tpu_torch.formats import gguf
    from light_whisper_tpu_torch.models.qwen3_asr import config as port_config
    from light_whisper_tpu_torch.models.qwen3_asr.export import write_model

    ref_path, port_path = str(tmp_path / "ref.gguf"), str(tmp_path / "port.gguf")
    cfg = write_tiny_model(ref_path, quantize=quantize, seed=4)
    tokens, types = tiny_vocab()
    meta = {"tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types, "tokenizer.ggml.merges": [],
            "tokenizer.chat_template": "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n"}
    write_model(port_path, _port_config(cfg), tiny_tensors(cfg, 4), meta, quantize=quantize)
    assert pathlib.Path(port_path).read_bytes() == pathlib.Path(ref_path).read_bytes()

    ref, port = ref_gguf.read_gguf(ref_path), gguf.read_gguf(ref_path)
    try:
        assert port.metadata == ref.metadata
        assert list(port.tensors) == list(ref.tensors)
        for name, t in ref.tensors.items():
            p = port.tensors[name]
            assert (p.shape, p.ggml_type, p.data_offset, p.nbytes) == (t.shape, t.ggml_type, t.data_offset, t.nbytes)
            np.testing.assert_array_equal(p.array(), t.array())
            if t.ggml_type == ref_gguf.GGML_Q8_0:
                for a, b in zip(p.q8_0_parts(), t.q8_0_parts()):
                    np.testing.assert_array_equal(a, b)
        assert dataclasses.asdict(port_config.config_from_metadata(port.metadata)) == dataclasses.asdict(cfg)
    finally:
        ref.close()
        port.close()


# -- tokenizer and prompt -----------------------------------------------------------


def _tokenizers():
    from light_whisper_tpu.models.qwen3_asr.tokenizer import BPETokenizer as Ref
    from light_whisper_tpu_torch.models.qwen3_asr.tokenizer import BPETokenizer, byte_to_unicode

    b2u = byte_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    merges = []
    for left, right in (("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"), (b2u[32], "w"), ("o", "r")):
        merges.append(f"{left} {right}")
        tokens.append(left + right)
    tokens += ["<|im_start|>", "<|im_end|>", "<|audio_pad|>"]
    types = [1] * (len(tokens) - 3) + [3, 3, 3]
    return BPETokenizer(tokens, merges, types), Ref(tokens, merges, types)


@pytest.mark.parametrize("text", ["hello world", "<|im_start|>user\nhello<|im_end|>", "naïve 你好 123 4567",
                                  "  spaces\n\nand lines  "])
def test_tokenizer_round_trip(text):
    port, ref = _tokenizers()
    ids = port.encode(text)
    assert ids == ref.encode(text)
    assert port.decode(ids) == ref.decode(ids)
    assert port.decode(ids, skip_special=False) == ref.decode(ids, skip_special=False) == text


@pytest.mark.parametrize("template", [
    None,
    "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n",
    "{% for m in messages %}<|im_start|>{{ m.role }}\n{% for c in m.content %}"
    "{% if c.type == 'audio' %}<|audio_pad|>{% else %}{{ c.text }}{% endif %}{% endfor %}<|im_end|>\n"
    "{% endfor %}{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}",
    "{{ unrenderable",
], ids=["default", "audio-placeholder", "jinja", "broken-jinja"])
def test_prompt_ids(template):
    from light_whisper_tpu.models.qwen3_asr.prompt import resolve_prompt_ids as ref_ids
    from light_whisper_tpu_torch.models.qwen3_asr.prompt import resolve_prompt_ids

    port, ref = _tokenizers()
    audio_id = port.token_to_id["<|audio_pad|>"]
    got = resolve_prompt_ids(template, port, audio_id, context="hello")
    assert got == ref_ids(template, ref, audio_id, context="hello")
    assert got[0] and got[1]


# -- VAD segmenter ------------------------------------------------------------------


def _probabilities(seed):
    rng = np.random.default_rng(seed)
    probs = np.concatenate([rng.uniform(0, 0.3, 80), rng.uniform(0.6, 1.0, 120), rng.uniform(0, 0.4, 25),
                            rng.uniform(0.55, 1.0, 40), rng.uniform(0, 0.2, 60), rng.uniform(0.3, 0.7, 90)])
    return probs.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("options", [{}, {"threshold": 0.6, "min_silence_duration_ms": 100, "speech_pad_ms": 30}],
                         ids=["defaults", "tight"])
def test_speech_segments(seed, options):
    from light_whisper_tpu.models.vad import segmenter as ref
    from light_whisper_tpu.native import binding
    from light_whisper_tpu_torch.models.vad import segmenter

    probs = _probabilities(seed)
    n = len(probs) * 160 + 77
    got = segmenter.speech_segments(probs, n, segmenter.SegmenterOptions(**options))
    assert got == ref.speech_segments(probs, n, ref.SegmenterOptions(**options))
    assert len(got) >= 1
    if binding.available():  # the reference's C++ twin, which the port does not carry
        o = segmenter.SegmenterOptions(**options)
        pairs = binding.vad_segments(probs, n, threshold=o.threshold, smooth_window=o.smooth_window_frames,
                                     min_speech_ms=o.min_speech_duration_ms,
                                     min_silence_ms=o.min_silence_duration_ms, pad_ms=o.speech_pad_ms)
        assert [{"start": s, "end": e} for s, e in pairs] == got


# -- PCM ------------------------------------------------------------------------------


def test_pcm_decode_and_resample(tmp_path):
    from light_whisper_tpu.audio import pcm as ref
    from light_whisper_tpu.native import binding
    from light_whisper_tpu_torch.audio import pcm

    rng = np.random.default_rng(5)
    samples = (rng.standard_normal(7001) * 8000).clip(-32768, 32767).astype("<i2")
    payload = base64.b64encode(samples.tobytes()).decode()
    for rate in (16000, 44100):
        got, dur = pcm.decode_inline_audio(payload, "pcm_s16le", rate)
        want, want_dur = ref.decode_inline_audio(payload, "pcm_s16le", rate)
        np.testing.assert_array_equal(got, want)
        assert dur == want_dur
    for bad in (base64.b64encode(b"\x01\x02\x03").decode(), "%%%"):
        with pytest.raises(ValueError) as got_exc:
            pcm.decode_inline_audio(bad, "pcm_s16le", 16000)
        with pytest.raises(ValueError) as want_exc:
            ref.decode_inline_audio(bad, "pcm_s16le", 16000)
        assert str(got_exc.value).split(":")[0] == str(want_exc.value).split(":")[0]
    audio = rng.standard_normal(48000).astype(np.float32)
    for source in (48000, 44100, 8000, 16000):
        got = pcm.resample_linear(audio, source)
        np.testing.assert_array_equal(got, ref.resample_linear(audio, source))
        if binding.available() and source != 16000:
            np.testing.assert_allclose(got, binding.resample_linear(audio, source), rtol=0, atol=1e-6)
    path = tmp_path / "stereo.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(22050)
        w.writeframes(samples[:7000].tobytes())
    got, got_rate = pcm.read_audio_file_mono_f32(str(path))
    want, want_rate = ref.read_audio_file_mono_f32(str(path))
    np.testing.assert_array_equal(got, want)
    assert got_rate == want_rate == 22050


# -- hot words, model cache, long-form windows, speech-like audio ---------------------


@pytest.mark.parametrize("text,hot", [
    ("我在用拍森写代码", ["派森"]),
    ("I use pytorch and jacks daily", ["PyTorch", "JAX"]),
    ("deploy the kuber netes cluster", ["Kubernetes"]),
    ("the lite whisper app", ["Light-Whisper", "whisper"]),
    ("no change here", []),
])
def test_hot_words(text, hot):
    from light_whisper_tpu.text.hotwords import HotWordCorrector as Ref
    from light_whisper_tpu_torch.text.hotwords import HotWordCorrector

    assert HotWordCorrector().correct(text, hot) == Ref().correct(text, hot)


def test_find_snapshot_file(tmp_path, monkeypatch):
    from light_whisper_tpu.download import cache as ref
    from light_whisper_tpu_torch.download import cache

    assert cache.QWEN3_ASR_MODELS == ref.QWEN3_ASR_MODELS
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    spec = cache.QWEN3_ASR_MODELS["qwen3-asr-0.6b"]
    repo = tmp_path / ("models--" + spec["repo_id"].replace("/", "--"))
    for snap, size in (("old", 2_000_000), ("main", 1_500_000), ("tiny", 10)):
        (repo / "snapshots" / snap).mkdir(parents=True)
        (repo / "snapshots" / snap / spec["filename"]).write_bytes(b"\0" * size)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("main")
    for args in ((spec["repo_id"], spec["filename"]), (spec["repo_id"], "missing.gguf"), ("x/y", "z")):
        assert cache.find_snapshot_file(*args) == ref.find_snapshot_file(*args)
    assert cache.find_snapshot_file(spec["repo_id"], spec["filename"]).endswith(os.path.join("main", spec["filename"]))


@pytest.mark.parametrize("window", [28.0, 3.0, 1.0])
def test_plan_windows(window):
    from light_whisper_tpu.serving import longform as ref
    from light_whisper_tpu_torch.serving import longform

    segments = [{"start": 800, "end": 40_000}, {"start": 41_000, "end": 52_000},
                {"start": 90_000, "end": 600_000}, {"start": 601_000, "end": 610_000}]
    got = longform.plan_windows(segments, 620_000, window)
    assert got == ref.plan_windows(segments, 620_000, window) and got
    assert longform._join_texts(["Hello.", "world", "你好", "", "ok"]) == ref._join_texts(
        ["Hello.", "world", "你好", "", "ok"])


@pytest.mark.parametrize("seconds,seed", [(0.7, 1), (2.5, 7), (12.0, 5)])
def test_speechlike_bit_for_bit(seconds, seed):
    from light_whisper_tpu.eval.speechlike import speechlike as ref
    from light_whisper_tpu_torch.eval.speechlike import speechlike

    got = speechlike(seconds, seed=seed)
    assert got.dtype == np.float32 and np.array_equal(got, ref(seconds, seed=seed))


def test_chip_smoke_builds_the_reference_artifact_bytes(tmp_path):
    """``chip_smoke.py`` builds its artifacts with the port's own 0.6B widths
    and random-tensor builder (``models/qwen3_asr/synthetic.py``, which the
    multi-device dry run shares): the same widths as
    ``__graft_entry__._flagship_config("0.6b")``, and at a tiny width the same
    GGUF bytes from a seed as ``tests/helpers`` through the reference's export
    (the 0.6B file is ~1 GB; the draw code is shared)."""
    import importlib.util

    import __graft_entry__ as graft
    from light_whisper_tpu.models.qwen3_asr.export import write_model as ref_write
    from light_whisper_tpu_torch.models.qwen3_asr import synthetic

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert dataclasses.asdict(chip_smoke.qwen3_asr_06b_config()) == dataclasses.asdict(graft._flagship_config("0.6b"))

    cfg = tiny_config()
    port_cfg = _port_config(cfg)
    tensors = synthetic.random_tensors(port_cfg, seed=5)
    reference = tiny_tensors(cfg, seed=5)
    assert list(tensors) == list(reference)
    assert all(np.array_equal(tensors[k], reference[k]) for k in tensors)
    chip_smoke.write_model(str(tmp_path / "port.gguf"), port_cfg, seed=5)
    tokens, types = synthetic.vocab(port_cfg)
    meta = {"tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types, "tokenizer.ggml.merges": [],
            "tokenizer.chat_template": synthetic.TEMPLATE}
    ref_write(str(tmp_path / "ref.gguf"), cfg, reference, meta, quantize=True)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()

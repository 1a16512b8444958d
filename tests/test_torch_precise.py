"""Precise mode (``LIGHT_WHISPER_PRECISE=1``: dense f32 weights, f32 compute,
f32 KV cache) in the port against the reference's, on the CPU.

- On the tiny fixture, Q8_0 and dense, at three seeds, the port's precise
  ``Qwen3ASRModel`` and the reference's give identical greedy tokens; the
  logits after the prompt and after each token (teacher-forced on the
  reference's tokens) agree within 1e-5 of max(1, max|logit|) at every step:
  both sides compute in f32.
- On the wire, with ``LIGHT_WHISPER_PRECISE=1`` read by each server's own
  model factory, with session reuse off and on (a named stream growing over
  three requests), the replies agree field for field but ``inference_ms``.
  The port's served model is precise; every KV cache it makes, the sessions'
  included, is f32; and no Q8, attention, flash-prefill or fused-FFN kernel
  wrapper is called (each is replaced by one that raises).
"""

import base64
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.audio.mel import _log_mel_with_max
from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec
from light_whisper_tpu.models.qwen3_asr import model as ref_model_mod
from light_whisper_tpu.models.qwen3_asr.encoder import encode_chunks as ref_encode_chunks
from light_whisper_tpu.runtime.qwen3_server import Qwen3EngineServer as RefServer
from light_whisper_tpu.runtime.server import EngineServer
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr import model as port_model_mod
from light_whisper_tpu_torch.ops import linear as port_linear
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

MAX_NEW = 6
LOGIT_TOL = 1e-5
SR = 16000
FIELDS = ("success", "text", "raw_text", "language", "duration", "speech_duration", "vad_segments")
KERNEL_WRAPPERS = ((dec, ("decode_attention", "decode_attention_batched", "decode_attention_unstacked",
                          "flash_prefill", "fused_ffn_step", "q8_matmul_stacked", "q8_matmul_stacked_fused")),
                   (port_linear, ("q8_matmul",)))


@pytest.fixture(autouse=True)
def _no_shadow_warmup(monkeypatch):
    monkeypatch.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")


def _ref_teacher_forced(ref, request, prefix_len, tokens):
    """The reference's logits after the prompt and after each of ``tokens``:
    its ``_encode_and_prefill`` without the argmax, then one ``forward`` a
    token (the port's ``teacher_forced_logits``, in JAX)."""
    padded, n_audio, ids_padded, true_len, mel_frames, num_chunks = request
    cfg = ref.config
    mel, _ = _log_mel_with_max(jnp.asarray(padded), mel_frames)
    mel = jnp.pad(mel, ((0, num_chunks * cfg.audio.chunk_frames - mel.shape[0]), (0, 0)))
    audio = ref_encode_chunks(cfg.audio, ref.encoder_params, mel, jnp.int32(n_audio), num_chunks)
    embeds = ref_model_mod._build_prompt_embeds(ref.decoder_params, jnp.asarray(ids_padded.astype(np.int32)),
                                                audio, jnp.int32(n_audio), prefix_len, cfg.decoder.dtype)
    cache = ref._cache_for(len(ids_padded) + len(tokens) + 1)
    hidden, cache = ref_dec.forward(cfg.decoder, ref.decoder_params, embeds, cache)
    rows = [ref_dec.logits_for(cfg.decoder, ref.decoder_params, hidden[true_len - 1][None])[0]]
    cache = cache._replace(pos=jnp.int32(true_len))
    for tok in tokens:
        x = ref_dec.embed_tokens(ref.decoder_params, jnp.asarray([tok], jnp.int32))
        hidden, cache = ref_dec.forward(cfg.decoder, ref.decoder_params, x, cache)
        rows.append(ref_dec.logits_for(cfg.decoder, ref.decoder_params, hidden)[0])
    return [np.asarray(r, np.float32) for r in rows]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("quantize", [True, False], ids=["q8_0", "dense"])
def test_precise_tokens_and_logits_match_the_reference(tmp_path, quantize, seed):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_model(path, quantize=quantize, seed=seed)
    audio = speechlike(2.0, seed=seed + 1)
    ref = ref_model_mod.Qwen3ASRModel(path, max_new_tokens=MAX_NEW, precise=True)
    port = port_model_mod.Qwen3ASRModel(path, device="cpu", max_new_tokens=MAX_NEW, precise=True)
    assert port.cache_dtype == torch.float32 and port.config.decoder.compute_dtype == "float32"
    assert all(t.dtype == torch.float32 for t in _leaves(port.decoder_params) + _leaves(port.encoder_params)
               if t.is_floating_point())
    want = ref.transcribe(audio)
    got = port.transcribe(audio)

    ref_rows = _ref_teacher_forced(ref, port._prepare(audio), len(port.prefix_ids), want.tokens)
    port_rows = port.teacher_forced_logits(audio, want.tokens)
    vocab = port.config.decoder.vocab_size
    worst = []
    for r, p in zip(ref_rows, port_rows):
        r, p = r[:vocab], p.numpy()[:vocab]
        worst.append(float(np.abs(r - p).max()) / max(1.0, float(np.abs(r).max())))
    print(f"precise {'q8_0' if quantize else 'dense'} seed {seed}: tokens {want.tokens}; "
          f"max|Δlogit|/max(1, max|logit|) by step {[f'{w:.2g}' for w in worst]} (tol {LOGIT_TOL:g})")
    assert got.tokens == want.tokens
    assert (got.text, got.language) == (want.text, want.language)
    assert max(worst) <= LOGIT_TOL


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _b64(audio):
    pcm = np.clip(np.round(np.asarray(audio) * 32767.0), -32768, 32767).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode()


def _cmds():
    cmds = []
    stream = np.concatenate([np.zeros(SR // 2, np.float32), speechlike(3.0, seed=41)])
    for rid, seconds in enumerate((2.0, 2.5, 3.5), start=1):
        cmds.append({"action": "transcribe", "request_id": rid, "audio_base64": _b64(stream[: int(seconds * SR)]),
                     "audio_format": "pcm_s16le", "sample_rate": SR, "options": {"stream": "dictation"}})
    padded = np.concatenate([np.zeros(8000, np.float32), speechlike(1.5, seed=42), np.zeros(8000, np.float32)])
    for rid, audio in ((4, speechlike(2.5, seed=43)), (5, padded), (6, np.zeros(SR, np.float32))):
        cmds.append({"action": "transcribe", "request_id": rid, "audio_base64": _b64(audio),
                     "audio_format": "pcm_s16le", "sample_rate": SR})
    return cmds + [{"action": "exit", "request_id": 99}]


def _serve(engine, cmds):
    out = io.StringIO()
    stdin = io.StringIO("".join(json.dumps(c) + "\n" for c in cmds))
    EngineServer(engine.hooks(), stdin=stdin, stdout=out, max_concurrency=1).run()
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    return {r.get("request_id"): r for r in lines[1:]}


@pytest.mark.parametrize("sessions", [False, True], ids=["stateless", "sessions"])
def test_precise_wire_replies_match_the_reference(tmp_path, monkeypatch, sessions):
    path = str(tmp_path / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=2)
    monkeypatch.setenv("LIGHT_WHISPER_PRECISE", "1")
    monkeypatch.setenv("LWT_VAD_NUMPY", "0")
    if sessions:
        monkeypatch.delenv("LIGHT_WHISPER_DISABLE_SESSION_REUSE", raising=False)
    else:
        monkeypatch.setenv("LIGHT_WHISPER_DISABLE_SESSION_REUSE", "1")

    # each server's own factory reads LIGHT_WHISPER_PRECISE; only the decode budget is cut
    ref_cls, port_cls = ref_model_mod.Qwen3ASRModel, port_model_mod.Qwen3ASRModel
    monkeypatch.setattr(ref_model_mod, "Qwen3ASRModel",
                        lambda p, **kw: ref_cls(p, max_new_tokens=MAX_NEW, **kw))
    monkeypatch.setattr(port_model_mod, "Qwen3ASRModel",
                        lambda p, **kw: port_cls(p, max_new_tokens=MAX_NEW, **kw))
    cmds = _cmds()
    ref = _serve(RefServer(model_path=path), cmds)

    cache_dtypes = []

    def recorded(real):
        def make(*args, **kwargs):
            cache = real(*args, **kwargs)
            cache_dtypes.append(cache.k.dtype)
            return cache
        return make

    for fn in ("init_cache", "init_cache_batch"):
        monkeypatch.setattr(dec, fn, recorded(getattr(dec, fn)))

    def refuse(name):
        def call(*_a, **_kw):
            raise AssertionError(f"precise mode called the kernel wrapper {name}")
        return call

    for module, names in KERNEL_WRAPPERS:
        for name in names:
            monkeypatch.setattr(module, name, refuse(name))
    engine = Qwen3EngineServer(model_path=path, device="cpu")
    port = _serve(engine, cmds)

    assert engine.model.cache_dtype == torch.float32
    assert engine.model.config.decoder.compute_dtype == "float32"
    assert cache_dtypes and set(cache_dtypes) == {torch.float32}, cache_dtypes
    for rid in range(1, 7):
        a, b = ref[rid], port[rid]
        assert set(a) == set(b), rid
        for field in FIELDS:
            assert a.get(field) == b.get(field), (rid, field, a.get(field), b.get(field))
    assert port[1]["vad_segments"] >= 1 and port[1]["inference_ms"] > 0
    assert port[99]["success"] is True
    if sessions:
        assert engine._session_pool.stats()["session_hits"] >= 1

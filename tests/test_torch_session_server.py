"""The port's engine server against the reference's on the wire, session reuse ON.

Both serve the same tiny GGUF through ``EngineServer`` on in-memory pipes and
take the same requests: an interim loop of growing requests on a named
stream, two interleaved streams, an anonymous growing pair (the default
session), and, behind a VAD whose leading trim wobbles, growing requests with
jitter within and beyond ``TRIM_PIN_TOLERANCE_SAMPLES``. Replies must agree on
``text``, ``raw_text``, ``language``, ``duration``, ``speech_duration`` and
``vad_segments``; ``stats`` on every session, trim-pin and VAD-reuse field.
The reference's VAD session takes its halo path (``LWT_VAD_NUMPY=0``), the one
the port keeps.

Where the texts part, the seams must still have handed both models the same
trimmed bytes, and the port's tick must be the port's stateless
``transcribe`` of them (a flip there only inside the 1e-3 tie band); the
parting then lies below the seams, in one of two places, printed with the
port's top-2 gap: the two packages' stateless transcribes part (a model-level
flip on the tiny fixture's flat logits), or the reference's own tick parts
from its stateless result (its segment and full prefills are different XLA
programs).
"""

import base64
import io
import json

import numpy as np
import pytest

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.eval.speechlike import speechlike
from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
from light_whisper_tpu.runtime import qwen3_server as ref_server_mod
from light_whisper_tpu.runtime.qwen3_server import Qwen3EngineServer as RefServer
from light_whisper_tpu.runtime.server import EngineServer
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.runtime import qwen3_server as port_server_mod
from light_whisper_tpu_torch.runtime.qwen3_server import Qwen3EngineServer

SR = 16000
MAX_NEW = 6
FIELDS = ("text", "raw_text", "language", "duration", "speech_duration", "vad_segments")
STATS = ("session_hits", "session_resets", "session_hit_rate", "session_streams", "session_evictions",
         "session_parked_audio_bytes", "trim_pin_retained_bytes", "vad_session_retained_bytes",
         "vad_prefix_reuse", "speculative_decoding", "batched_tick_dispatches", "batch_dispatches",
         "batched_requests", "transcription_count", "vad_calls", "vad_rejected")
# no request_id: the server answers it after every pipelined request (reply key None)
STATS_CMD = {"action": "stats"}
TIE_BAND = 1e-3


def _b64(audio):
    pcm = np.clip(np.round(np.asarray(audio) * 32767.0), -32768, 32767).astype("<i2")
    return base64.b64encode(pcm.tobytes()).decode()


def _transcribe(rid, audio, stream=None):
    cmd = {"action": "transcribe", "request_id": rid, "audio_base64": _b64(audio), "audio_format": "pcm_s16le",
           "sample_rate": SR}
    if stream:
        cmd["options"] = {"stream": stream}
    return cmd


class JitterVad:
    """One speech segment whose leading trim moves by ``start_jitter`` per call."""

    def __init__(self, true_start, start_jitter):
        self.true_start, self.start_jitter, self.calls = true_start, list(start_jitter), 0

    def speech_timestamps(self, audio):
        start = self.true_start + self.start_jitter[self.calls % len(self.start_jitter)]
        self.calls += 1
        return [{"start": start, "end": len(audio) - 160}]

    def warmup(self):
        pass


def _serve(engine, cmds):
    """Replies by request id, and the (trimmed audio, tokens) of each request
    that reached the model, in order."""
    calls = []
    real = engine._transcribe_model

    def spy(audio, session_key):
        result = real(audio, session_key)
        calls.append((np.array(audio), list(result.tokens)))
        return result

    engine._transcribe_model = spy
    out = io.StringIO()
    stdin = io.StringIO("".join(json.dumps(c) + "\n" for c in cmds))
    EngineServer(engine.hooks(), stdin=stdin, stdout=out, max_concurrency=1).run()
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    return {r.get("request_id"): r for r in lines[1:]}, calls


def _pair(path, cmds, vad_factory=None):
    kwargs = {"vad_factory": vad_factory} if vad_factory else {}
    ref = _serve(RefServer(model_path=path, model_factory=lambda p: RefModel(p, max_new_tokens=MAX_NEW),
                           **kwargs), cmds)
    port = _serve(Qwen3EngineServer(model_path=path, device="cpu",
                                    model_factory=lambda p: Qwen3ASRModel(p, device="cpu", max_new_tokens=MAX_NEW),
                                    **kwargs), cmds)
    return ref, port, path


def _loop_cmds():
    lead = np.zeros(SR // 2, np.float32)
    dictation = np.concatenate([lead, speechlike(5.0, seed=31)])
    s1 = np.concatenate([lead, speechlike(4.0, seed=32)])
    s2 = np.concatenate([lead, speechlike(4.0, seed=33)])
    anon = speechlike(3.0, seed=34)
    cmds, rid = [], 0
    plan = [(dictation, s, "dictation") for s in (2.0, 2.5, 3.0, 4.0, 5.5)]
    plan += [(s1, 2.0, "s1"), (s2, 2.0, "s2"), (s1, 3.0, "s1"), (s2, 3.5, "s2"), (s1, 4.5, "s1")]
    plan += [(anon, 2.0, None), (anon, 3.0, None)]
    for audio, seconds, stream in plan:
        rid += 1
        cmds.append(_transcribe(rid, audio[: int(seconds * SR)], stream))
    return cmds + [STATS_CMD]


def _jitter_cmds(lead):
    full = np.concatenate([np.zeros(lead, np.float32), speechlike(5.0, seed=35)])
    cmds = [_transcribe(rid, full[: lead + int(s * SR)]) for rid, s in enumerate((2.0, 3.0, 3.5, 4.0, 5.0), 1)]
    return cmds + [STATS_CMD]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sess-srv") / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=2)
    mp = pytest.MonkeyPatch()
    mp.delenv("LIGHT_WHISPER_DISABLE_SESSION_REUSE", raising=False)
    mp.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")
    mp.setenv("LWT_VAD_NUMPY", "0")
    try:
        lead = SR
        out = {"loop": _pair(path, _loop_cmds())}
        within = ref_server_mod.TRIM_PIN_TOLERANCE_SAMPLES - 400
        beyond = ref_server_mod.TRIM_PIN_TOLERANCE_SAMPLES + 160
        out["jitter-within"] = _pair(path, _jitter_cmds(lead), lambda: JitterVad(lead, [0, 160, within, -320]))
        out["jitter-beyond"] = _pair(path, _jitter_cmds(lead), lambda: JitterVad(lead, [0, beyond]))
    finally:
        mp.undo()
    return out


def test_trim_pin_constants_match_the_reference():
    for name in ("TRIM_PIN_TOLERANCE_SAMPLES", "TRIM_PIN_MAX_SAMPLES", "DEFAULT_TRIM_PIN_MAX_BYTES"):
        assert getattr(port_server_mod, name) == getattr(ref_server_mod, name)


def _gap(model, audio, tokens, other):
    """Where ``tokens`` and ``other`` part, and the port's top-2 gap there on
    the path of ``tokens``."""
    step = next((i for i, (a, b) in enumerate(zip(tokens, other)) if a != b), min(len(tokens), len(other)))
    logits = model.teacher_forced_logits(audio, tokens[:step])[step].numpy()[: model.config.decoder.vocab_size]
    top2 = np.sort(logits)[-2:]
    return step, float(top2[1] - top2[0])


def _parting_below_the_seams(path, ref_call, port_call):
    audio, ref_tokens = ref_call
    port_audio, port_tokens = port_call
    np.testing.assert_array_equal(port_audio, audio)  # the seams trimmed the same bytes
    port_model = Qwen3ASRModel(path, device="cpu", max_new_tokens=MAX_NEW)
    port_stateless = port_model.transcribe(audio).tokens
    if port_tokens != port_stateless:
        step, gap = _gap(port_model, audio, port_stateless, port_tokens)
        print(f"port tick parts from its stateless transcribe at step {step}: top-2 gap {gap:.3g}")
        assert gap <= TIE_BAND, (step, gap)
    ref_stateless = RefModel(path, max_new_tokens=MAX_NEW).transcribe(audio).tokens
    if ref_stateless != port_stateless:
        step, gap = _gap(port_model, audio, port_stateless, ref_stateless)
        print(f"the packages' stateless transcribes part at step {step}: port top-2 gap {gap:.3g}")
    else:
        assert ref_tokens != ref_stateless, "the replies part but every path agrees"
        step, gap = _gap(port_model, audio, port_stateless, ref_tokens)
        print(f"the reference's tick parts from its stateless transcribe at step {step}: port top-2 gap {gap:.3g}")


@pytest.mark.parametrize("run", ["loop", "jitter-within", "jitter-beyond"])
def test_replies_agree(served, run):
    (ref, ref_calls), (port, port_calls), path = served[run]
    rids = sorted(r for r in ref if r is not None)
    assert rids and sorted(r for r in port if r is not None) == rids
    assert len(ref_calls) == len(port_calls) == len(rids)
    for i, rid in enumerate(rids):
        a, b = ref[rid], port[rid]
        assert a["success"] is True and b["success"] is True, (rid, a, b)
        assert set(a) == set(b)
        for field in FIELDS:
            if field in ("text", "raw_text") and a[field] != b[field]:
                _parting_below_the_seams(path, ref_calls[i], port_calls[i])
                continue
            assert a.get(field) == b.get(field), (rid, field)
        assert b["vad_segments"] >= 1 and b["backend"] == "cpu"


@pytest.mark.parametrize("run", ["loop", "jitter-within", "jitter-beyond"])
def test_stats_agree(served, run):
    (ref, _), (port, _), _path = served[run]
    a, b = ref[None]["stats"], port[None]["stats"]
    assert set(b) >= set(a) - {"scheduler"}
    for key in STATS:
        assert b[key] == a[key], (key, a[key], b[key])
    assert b["speculative_decoding"] is True
    assert b["batched_tick_degrades"] == 0


def test_the_interim_loop_reuses_sessions(served):
    port = served["loop"][1][0]
    stats = port[None]["stats"]
    streams = stats["session_streams"]
    assert streams["dictation"] == {"hits": 4, "resets": 1}
    assert streams["s1"] == {"hits": 2, "resets": 1} and streams["s2"] == {"hits": 1, "resets": 1}
    assert streams["__default__"] == {"hits": 1, "resets": 1}
    assert stats["vad_prefix_reuse"] >= 6
    assert stats["trim_pin_retained_bytes"] > 0 and stats["vad_session_retained_bytes"] > 0


def test_trim_pins_hold_within_the_tolerance_only(served):
    within = served["jitter-within"][1][0][None]["stats"]
    beyond = served["jitter-beyond"][1][0][None]["stats"]
    assert (within["session_hits"], within["session_resets"]) == (4, 1)
    # the second tick moves the trim past the tolerance: a fresh trim, a reset;
    # the third returns within the tolerance of the second and pins to it
    assert beyond["session_resets"] >= 2
    assert beyond["vad_prefix_reuse"] == 0  # a VAD without probabilities has no prefix session

"""The architecture seam changes nothing, and takes a new architecture as
files alone.

The pinned numbers were read from the harness before the seam (one module
that knew only Qwen3-ASR): the tiny artifact's bytes, every reader's value
on one synthetic record, and the plain reference's logits and gaps.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from harness import artifact, measures, spec, trace, traffic
from harness.client import Request
from harness.reference import Reference

from conftest import BENCH, QWEN3_ASR, REPO, TINY_LIMITS, run_env, tiny_config

TINY_SHA256 = "c8d4e0d7d366fdc3ea90e3a4d0e569d7b13ad2af069ae9de4ef4b62982846972"
TINY_BYTES = 323_936


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_the_tiny_artifact_keeps_its_bytes(tmp_path):
    cfg = tiny_config()
    path = tmp_path / "tiny.gguf"
    artifact.write(str(path), QWEN3_ASR, QWEN3_ASR.shapes(cfg), cfg["weights_seed"], "cpu")
    assert os.path.getsize(path) == TINY_BYTES and sha256(path) == TINY_SHA256


# -- every reader on one synthetic record -----------------------------------------

BUDGET = 40


def _request(rid, t_sent, t_reply, speech=11.49, ok=True, steps=None, inference=300.0, vad=4.0):
    r = Request(rid % 8, rid % 5, rid, t_sent, t_reply)
    r.reply = ({"success": True, "vad_segments": 1, "duration": 12.0, "speech_duration": speech, "vad_ms": vad,
                "inference_ms": inference, "text": ""} if ok else {"success": False})
    r.tokens = [300 + rid] * BUDGET if ok else None
    r.steps = steps
    return r


def _requests():
    out = [_request(1, 0.01, 0.52, speech=11.41, steps=[0.004] * (BUDGET - 1), inference=280.0),  # in the slice
           _request(2, 0.53, 1.10, speech=11.62, steps=[0.0042] * (BUDGET - 1), inference=290.0)]
    shared = [0.0045 + 0.0001 * i for i in range(BUDGET - 1)]  # one batched list, two requests
    for i in range(3, 15):
        t = 1.2 + 0.45 * (i - 3)
        steps = shared if i in (5, 6) else [0.0037 + 0.00001 * i] * (BUDGET - 1)
        out.append(_request(i, t, t + 0.25 + 0.01 * i, speech=11.2 + 0.03 * i, steps=steps,
                            inference=200.0 + 3.0 * i, vad=3.0 + 0.1 * i))
    out.append(_request(15, 6.9, 7.3, ok=False))
    out.append(_request(16, 9.8, 10.6, speech=11.3, steps=[0.004] * (BUDGET - 1)))  # answered after the close
    return out


def _spans(**named):
    return {name.replace("__", "."): {"count": n, "total_ms": ms} for name, (n, ms) in named.items()}


BEFORE = {"transcription_count": 10, "batched_requests": 4, "batch_dispatches": 1,
          "spans": _spans(scheduler__queue=(4, 400.0), model__decode__step=(78, 300.0),
                          model__decode__sync=(78, 220.0), model__decode__capture=(2, 70.0),
                          model__decode__replay=(76, 4.0), model__encode=(2, 50.0), model__prefill=(2, 80.0),
                          wire__parse=(4, 0.4), wire__pool_wait=(4, 0.1), wire__audio=(4, 2.0),
                          wire__reply=(4, 1.0), vad=(4, 14.0))}
AFTER = {"transcription_count": 26, "batched_requests": 12, "batch_dispatches": 3,
         "spans": _spans(scheduler__queue=(20, 2_400.0), model__decode__step=(702, 2_900.0),
                         model__decode__sync=(702, 2_050.0), model__decode__capture=(18, 640.0),
                         model__decode__replay=(684, 35.0), model__encode=(18, 460.0), model__prefill=(18, 700.0),
                         wire__parse=(20, 2.4), wire__pool_wait=(20, 0.5), wire__audio=(20, 10.0),
                         wire__reply=(20, 5.0), vad=(20, 70.0))}


def _slice(s, reqs):
    """A traced slice of two requests whose launch counts agree with the
    0.6B decoder's: 2 prefills and 78 decode forwards."""
    L, A = s.layers, s.a_layers
    prefills, forwards = 2, 2 * (BUDGET - 1)
    counters = {"q8_matmul_stacked_fused": 4 * L * forwards, "q8_matmul_stacked": 4 * L * prefills,
                "q8_matmul": (3 + 6 * A) * prefills + forwards + prefills, "decode_attention": 0,
                "decode_attention_batched": L * forwards, "decode_attention_unstacked": 0}
    gemv = (4 * L + 1) * forwards + prefills
    tile = counters["q8_matmul"] + counters["q8_matmul_stacked"] + counters["q8_matmul_stacked_fused"] - gemv
    times = {"void q8_gemv_kernel<0>(x)": 0.0671, "void q8_tile_kernel<4>(x)": 0.0069,
             "void attention_small_kernel<128, 2>(x)": 0.0166, "elementwise_kernel": 0.0288}
    counts = {"void q8_gemv_kernel<0>(x)": gemv, "void q8_tile_kernel<4>(x)": tile,
              "void attention_small_kernel<128, 2>(x)": L * forwards, "elementwise_kernel": 5000}
    return trace.Slice(window_s=1.069, busy_s=0.329, kernel_time_s=times, kernel_count=counts,
                       idle_by_host={"cudaGraphLaunch": 0.34, "python": 0.23}, launches=counters, requests=reqs)


def synthetic_record(arch):
    """Published 0.6B shapes, 16 requests (two in a traced slice, one failed,
    one answered after the close), spans and counters before and after."""
    with open(os.path.join(BENCH, "configs", "qwen3-asr-0.6b.json")) as f:
        s = arch.shapes(json.load(f))
    reqs = _requests()
    return measures.Record(cell="qwen3-asr-0.6b.dictation", shapes=s, arch=arch, budget=BUDGET, seconds=10.0,
                           setup_s=17.5, requests=reqs, t_open=0.0, stats_before=BEFORE, stats_after=AFTER,
                           slice=_slice(s, reqs[:2]), slice_span=(0.0, 1.2))


PARENT_VALUES = {
    "latency_p50_ms": 349.99999999999966, "latency_p90_ms": 546.0, "audio_s_per_s": 16.8,
    "wire_ms.latency": 105.64999999999998, "wire_ms.throughput": 105.64999999999998,
    "dispatch_size.throughput": 1.6, "vad_ms.latency": 3.8499999999999996,
    "decode_step_ms.latency": 4.028181818181819, "prefill_ms.latency": 77.88499999999999,
    "mfu.latency": 0.042058221280632406, "mfu.throughput": 0.042058221280632406,
    "gemv_roofline.latency": 22.203554379518202, "gemv_roofline.throughput": 22.203554379518202,
    "attention_roofline.latency": 3.04033536414314, "attention_roofline.throughput": 3.04033536414314,
    "idle_share.latency": 69.22357343311506, "idle_share.throughput": 69.22357343311506,
    "queue_ms.throughput": 125.0, "decode_step_ms.throughput": 4.166666666666667,
    "decode_host_ms.latency": 1.233974358974359, "decode_host_ms.throughput": 1.233974358974359,
    "encoder_ms.latency": 25.625, "decoder_prefill_ms.latency": 38.75, "wire_server_ms.throughput": 0.9,
    "decode_replay_share.latency": 97.43589743589743, "decode_replay_share.throughput": 97.43589743589743,
}


def test_every_metric_has_a_pinned_value():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]} - {"setup_s"}
    assert names == set(PARENT_VALUES)


@pytest.mark.parametrize("name", sorted(PARENT_VALUES))
def test_every_reader_gives_the_parents_value(name):
    assert spec.reader(name, REPO)(synthetic_record(QWEN3_ASR)) == PARENT_VALUES[name]


def test_a_reader_without_its_count_reads_nothing_and_says_why(capsys):
    lacking = type(sys)("lacking")
    lacking.__file__ = "lacking.py"
    for name in ("shapes", "stacked_launches", "q8_matmul_launches", "gemv_launches", "decode_attention_launches",
                 "decode_attention_bytes"):
        setattr(lacking, name, getattr(QWEN3_ASR, name))
    rec = synthetic_record(lacking)
    assert spec.reader("attention_roofline.latency", REPO)(rec) == PARENT_VALUES["attention_roofline.latency"]
    assert spec.reader("gemv_roofline.latency", REPO)(rec) is None
    assert spec.reader("mfu.latency", REPO)(rec) is None
    err = capsys.readouterr().err
    assert "no gemv_roofline: archs/lacking.py has no gemv_step_bytes, head_bytes" in err
    assert "no mfu: archs/lacking.py has no request_flops" in err


# -- the plain reference ------------------------------------------------------------

MIX = {"loop": "closed", "clips": 3,
       "speech_seconds": {"distribution": "lognormal", "median": 4.0, "sigma": 0.6, "min": 2.0, "max": 20.0},
       "lead_silence_seconds": 0.3, "trail_silence_seconds": 0.5, "silence_noise_lsb": 3.0, "clients": 1, "cycles": 1}
# a request each: the sum and the absolute sum of its logits, each row's best logit and pick, the control's
# sum and picks (float64 sums of float32 logits)
PARENT_LOGITS = [
    (12.29622929499817, 538.4178266619441,
     [1.204054355621338, 1.2094768285751343, 1.3595677614212036, 1.2593072652816772, 1.081838846206665,
      1.1894339323043823], [405, 405, 334, 405, 454, 454], 8.054379934066674, [405, 405, 334, 405, 454, 454]),
    (-4.177951778596025, 542.4595046026714,
     [1.1881707906723022, 1.2245303392410278, 1.3228801488876343, 1.315481424331665, 1.3420841693878174,
      1.1110540628433228], [405] * 6, -4.202036766810124, [405] * 6),
    (4.1579045115681765, 548.8777672042565,
     [1.1967183351516724, 1.3111402988433838, 1.3119847774505615, 1.2727370262145996, 1.2232426404953003,
      1.2222175598144531], [405] * 6, 3.032810762624649, [405] * 6),
]


def test_the_reference_logits_are_the_parents():
    ref = Reference(tiny_config(), QWEN3_ASR, "cpu", control=True)
    clips = traffic.generate(MIX, 21).utterances
    requests = [(ref.vad.trim(pcm)[0], [256 + (37 * i + 11 * k) % 250 for i in range(6)])
                for k, pcm in enumerate(clips)]
    for got, (total, absolute, best, picks, ctl_total, ctl_picks) in zip(ref.score(requests), PARENT_LOGITS):
        r, c = got["ref"].double(), got["ctl"].double()
        assert float(r.sum()) == total and float(r.abs().sum()) == absolute
        assert r.max(-1).values.tolist() == best and r.argmax(-1).tolist() == picks
        assert float(c.sum()) == ctl_total and c.argmax(-1).tolist() == ctl_picks


# A rehearsal of tiny.dictation on seed 41 serves the clips in this order; each clip's served tokens, trimmed
# samples, and the (sum, widest) of its tokens' logit gaps and of the control's picks' gaps.
SEED = 41
PARENT_GAPS = {
    41: ([405] * 21 + [383] * 19, 183520, (0.0, 0.0), (0.0, 0.0)),
    59: ([405] * 15 + [383] * 25, 183680, (0.0, 0.0), (0.07516580820083618, 0.03161120414733887)),
    29: ([405] * 15 + [383] * 25, 183520, (0.0, 0.0), (0.02075052261352539, 0.02075052261352539)),
    61: ([405] * 15 + [383] * 25, 183520, (0.0, 0.0), (0.0, 0.0)),
    53: ([405] * 16 + [383] * 24, 183680, (0.0, 0.0), (0.011899232864379883, 0.011899232864379883)),
    48: ([405] * 16 + [383] * 24, 183680, (0.0, 0.0), (0.0084458589553833, 0.0084458589553833)),
    13: ([405] * 15 + [383] * 25, 183680, (0.0024219751358032227, 0.0024219751358032227),
         (0.029969453811645508, 0.027547478675842285)),
    56: ([405] * 15 + [383] * 25, 183680, (0.0032919645309448242, 0.0032919645309448242),
         (0.0032919645309448242, 0.0032919645309448242)),
}


def _dictation(seed):
    with open(os.path.join(BENCH, "traffic", "dictation.json")) as f:
        return traffic.generate(json.load(f), seed)


def _found(result):
    return (sum(result["gaps"]), max(result["gaps"])), (sum(result["control_gaps"]), max(result["control_gaps"]))


def test_the_reference_gaps_are_the_parents():
    clips = _dictation(SEED).utterances
    ref = Reference(tiny_config(), QWEN3_ASR, "cpu", control=True)
    results = ref.run([{"pcm": clips[u], "tokens": pinned[0]} for u, pinned in PARENT_GAPS.items()])
    for (u, (_tokens, samples, gaps, control_gaps)), res in zip(PARENT_GAPS.items(), results):
        assert (res["samples"], res["segments"]) == (samples, 1), u
        assert _found(res) == (gaps, control_gaps), u


def test_a_rehearsal_compares_as_the_parent_did(workspace, monkeypatch, capsys):
    """``calibrate.py --rehearse``: the program serves each clip the parent's
    tokens, and the reference and the control read the parent's gaps."""
    import calibrate
    from harness import reference

    seen = []
    run = reference.Reference.run

    def recorded(self, items):
        out = run(self, items)
        seen.extend(zip(items, out))
        return out

    monkeypatch.setattr(reference.Reference, "run", recorded)
    assert calibrate.main(["--workload", "tiny.dictation", "--seeds", str(SEED), "--seconds", "3", "--root",
                           str(workspace), "--rehearse"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["program_correct"] and not line["control_correct"]
    clips = _dictation(SEED).utterances
    order = list(PARENT_GAPS)
    compared = [next(u for u, pcm in enumerate(clips) if np.array_equal(pcm, item["pcm"])) for item, _res in seen]
    assert compared[:2] == order[:2] and len(compared) == line["compared"]
    for u, (item, res) in zip(compared, seen):
        if u in PARENT_GAPS:
            tokens, samples, gaps, control_gaps = PARENT_GAPS[u]
            assert (list(item["tokens"]), res["samples"]) == (tokens, samples), u
            assert _found(res) == (gaps, control_gaps), u


# -- an architecture added as files alone -------------------------------------------

WRAPPED = '''"""qwen3-asr under another name, writing the name of every call to wrapped.calls beside it."""

import os

from harness import spec

_HERE = os.path.dirname(os.path.abspath(__file__))
_BASE = spec.arch("qwen3-asr", os.path.dirname(os.path.dirname(_HERE)))


def _recorded(name):
    fn = getattr(_BASE, name)

    def call(*args, **kwargs):
        with open(os.path.join(_HERE, "wrapped.calls"), "a") as f:
            f.write(name + "\\n")
        return fn(*args, **kwargs)

    return call


for _name in {names!r}:
    globals()[_name] = _recorded(_name)
'''
ARTIFACT_CALLS = ("shapes", "tensor_specs", "metadata")
REFERENCE_CALLS = ("decoder_logits",)
COUNT_CALLS = ("request_flops", "gemv_step_bytes", "head_bytes", "decode_attention_bytes", "stacked_launches",
               "q8_matmul_launches", "gemv_launches", "decode_attention_launches")


def _hashes(root):
    out = {}
    for folder, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(folder, name)
            out[os.path.relpath(path, root)] = sha256(path)
    return out


def _add_config(workspace, name, cfg):
    bench_dir = workspace / "benchmark_torch"
    (bench_dir / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench_dir / "limits" / f"{name}.json").write_text(json.dumps(TINY_LIMITS))
    bench = json.loads((workspace / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "tiny test model", "file": f"benchmark_torch/configs/{name}.json",
                             "reduced": [], "why": "CPU rehearsal"})
    bench["workloads"].append({"name": f"{name}.dictation", "config": name, "traffic": "dictation", "chips": 1,
                               "why": "CPU rehearsal"})
    (workspace / "BENCHMARK.json").write_text(json.dumps(bench))


def _run(workspace, cell, seed):
    return subprocess.run([sys.executable, "benchmark_torch/run.py", "--workload", cell, "--seed", str(seed),
                           "--seconds", "3", "--trace", "0", "--rehearse"], cwd=workspace, env=run_env(),
                          capture_output=True, text=True, timeout=600)


def test_an_architecture_added_as_files_alone_runs_end_to_end(workspace):
    bench_dir = workspace / "benchmark_torch"
    before = _hashes(bench_dir)
    (bench_dir / "archs" / "wrapped.py").write_text(WRAPPED.format(names=ARTIFACT_CALLS + REFERENCE_CALLS
                                                                   + COUNT_CALLS))
    _add_config(workspace, "tiny-wrapped", {**tiny_config(), "arch": "wrapped"})
    calls = bench_dir / "archs" / "wrapped.calls"

    out = _run(workspace, "tiny-wrapped.dictation", 2**32 + 41)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0 and list(result)[-1] == "checks"
    assert set(ARTIFACT_CALLS + REFERENCE_CALLS) <= set(calls.read_text().split())
    built = workspace / "build" / "benchmark_torch" / f"tiny-wrapped-w{tiny_config()['weights_seed']}.gguf"
    assert sha256(built) == TINY_SHA256

    calls.unlink()
    wrapped = spec.find_cell(str(workspace), "tiny-wrapped.dictation").arch
    rec = synthetic_record(wrapped)
    for name, value in PARENT_VALUES.items():
        assert spec.reader(name, str(workspace))(rec) == value, name
    assert set(COUNT_CALLS) <= set(calls.read_text().split())

    after = _hashes(bench_dir)
    assert {path: after.get(path) for path in before} == before  # no file that was there changed


@pytest.mark.parametrize("arch", ["no-such-arch", "../archs/qwen3-asr", None])
def test_a_configuration_without_its_architecture_gives_no_result(workspace, arch):
    cfg = {k: v for k, v in tiny_config().items() if k != "arch"}
    if arch is not None:
        cfg["arch"] = arch
    _add_config(workspace, "tiny-other", cfg)
    out = _run(workspace, "tiny-other.dictation", 7)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "architecture" in out.stderr.strip().splitlines()[-1], out.stderr[-2000:]

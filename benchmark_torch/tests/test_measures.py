"""Tails and rates are taken over every request and the whole window; a
failure counts as never answered; a roofline needs the counts to agree."""

import math

import pytest

from harness import measures, trace
from harness.client import Request

from conftest import QWEN3_ASR, tiny_config

S = QWEN3_ASR.shapes(tiny_config())


def req(t_sent, t_reply, ok=True, duration=2.0, client=0):
    r = Request(client, 0, 0, t_sent, t_reply)
    r.reply = ({"success": True, "vad_segments": 1, "duration": duration, "speech_duration": 1.5, "vad_ms": 5.0,
                "inference_ms": 100.0, "text": ""} if ok else {"success": False})
    r.tokens = [300] * 4 if ok else None
    return r


def record(requests, seconds=10.0, **kw):
    return measures.Record(cell="tiny.dictation", shapes=S, arch=QWEN3_ASR, budget=4, seconds=seconds, setup_s=1.0,
                           requests=requests, t_open=0.0, stats_before=kw.get("before", {}),
                           stats_after=kw.get("after", {}), slice=kw.get("slice"))


def test_percentiles_count_failures_as_never_answered():
    done = [req(i, i + 0.1 * (i + 1)) for i in range(10)]  # 100 .. 1000 ms
    rec = record(done + [req(9.5, 9.6, ok=False)])
    assert measures.percentile_ms(rec, 50) == pytest.approx(600.0)
    assert measures.percentile_ms(rec, 90) == pytest.approx(1000.0)
    assert measures.percentile_ms(record(done), 90) == pytest.approx(910.0)
    rec = record(done[:8] + [req(8, 8.1, ok=False), req(9, 9.2, ok=False)])
    assert measures.percentile_ms(rec, 90) is None  # the tail reaches a failure


def test_rates_take_the_whole_window_and_only_what_it_answered():
    from harness import spec

    rate = spec.reader("audio_s_per_s")
    inside = [req(0, 1, duration=3.0), req(1, 2, duration=5.0), req(2, 3, ok=False, duration=7.0)]
    late = [req(9.5, 10.5, duration=11.0)]
    assert rate(record(inside + late, seconds=10.0)) == pytest.approx(0.8)
    assert measures.percentile_ms(record(late), 50) is None


def test_dispatch_size_counts_singles_and_batches():
    before = {"transcription_count": 10, "batched_requests": 4, "batch_dispatches": 1}
    after = {"transcription_count": 30, "batched_requests": 20, "batch_dispatches": 4}
    # 20 requests: 16 in 3 batches and 4 singles
    assert measures.dispatch_size(record([], before=before, after=after)) == pytest.approx(20 / 7)


def _slice(requests, forwards, prefills, gemv_launches=None, small=None):
    L, A = S.layers, S.a_layers
    counters = {"q8_matmul_stacked_fused": 4 * L * forwards, "q8_matmul_stacked": 4 * L * prefills,
                "q8_matmul": (3 + 6 * A) * prefills + forwards + prefills, "decode_attention": L * forwards,
                "decode_attention_batched": 0, "decode_attention_unstacked": 0}
    gemv = gemv_launches if gemv_launches is not None else (4 * L + 1) * forwards + prefills
    tile = counters["q8_matmul"] + counters["q8_matmul_stacked"] + counters["q8_matmul_stacked_fused"] - gemv
    small = small if small is not None else L * forwards
    return trace.Slice(window_s=1.0, busy_s=0.25, kernel_time_s={"q8_gemv_kernel<1>": 1e-3, "q8_tile_kernel<4>": 1e-3,
                                                                  "attention_small_kernel<128, 2>": 1e-4},
                       kernel_count={"q8_gemv_kernel<1>": gemv, "q8_tile_kernel<4>": tile,
                                     "attention_small_kernel<128, 2>": small},
                       idle_by_host={}, launches=counters, requests=requests)


def test_rooflines_need_counts_that_agree():
    reqs = [req(0, 0.5), req(0.5, 0.9)]
    good = record(reqs, slice=_slice(reqs, forwards=6, prefills=2))
    assert measures.gemv_roofline(good) > 0 and measures.attention_roofline(good) > 0
    assert measures.idle_share(good) == pytest.approx(75.0)
    stale = record(reqs, slice=_slice(reqs, forwards=6, prefills=2, gemv_launches=10))
    assert measures.gemv_roofline(stale) is None
    other = record(reqs, slice=_slice(reqs, forwards=6, prefills=2, small=7))
    assert measures.attention_roofline(other) is None
    assert measures.gemv_roofline(record(reqs)) is None  # no traced slice, nothing to read


def test_reduce_unions_device_time_and_names_gaps():
    device = [("k1", 0, 100), ("k2", 50, 100), ("k1", 400, 100)]
    host = [("aten::item", 150, 250), ("cudaLaunchKernel", 390, 20)]
    sl = trace.reduce(device, host, 1e-6, {}, [])
    assert sl.busy_s == pytest.approx(250e-9)
    assert sl.kernel_count == {"k1": 2, "k2": 1}
    assert sl.idle_by_host == {"aten::item": pytest.approx(250e-9)}
    assert math.isclose(sl.time_of("k"), 300e-9)


def test_a_split_metric_without_a_file_takes_its_base_reader():
    from harness import spec

    assert spec.reader("wire_ms.throughput") is not None and spec.reader("wire_ms.latency") is not None
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.latency")


def test_the_reference_compares_each_distinct_answer_once():
    from harness import runner

    def served(rid, clip, tokens):
        r = req(rid, rid + 0.5)
        r.rid, r.utterance, r.tokens = rid, clip, tokens
        return r

    a, b, c, d = served(1, 0, [300] * 4), served(2, 1, [301] * 4), served(3, 0, [300] * 4), served(4, 0, [302] * 4)
    failed = req(5, 5.5, ok=False)
    t = type("T", (), {"utterances": [[0] * 10, [0] * 10]})()
    assert runner.reference_sample([a, b, c, d, failed], t, 10, 1) == [a, b, d]
    assert len(runner.reference_sample([a, b, c, d], t, 2, 1)) == 2
    numbers = runner.gap_numbers([0.0, 0.0, 0.2, 0.1])
    assert numbers["mean_logit_gap"] == pytest.approx(0.075) and numbers["tokens_not_first"] == 2
    assert numbers["mean_square_logit_gap"] == pytest.approx(0.0125) and numbers["widest_logit_gap"] == 0.2
    checks = runner.gap_checks({"mean_logit_gap": 0.1}, numbers, 4, 8)
    assert set(checks) == {"tokens_not_compared", "mean_logit_gap"} and checks["tokens_not_compared"]["value"] == 4

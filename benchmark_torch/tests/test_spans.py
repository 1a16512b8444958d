"""The readers of the program's spans take the window's delta of ``stats``'
``spans``, and read nothing where a snapshot has none (an engine without
spans)."""

import json
import os

import pytest

from harness import measures, spec

from conftest import QWEN3_ASR, REPO, tiny_config

S = QWEN3_ASR.shapes(tiny_config())
NEW = ("queue_ms.throughput", "decode_step_ms.throughput", "decode_host_ms.latency", "decode_host_ms.throughput",
       "encoder_ms.latency", "decoder_prefill_ms.latency", "wire_server_ms.throughput")


def spans(**named):
    return {name.replace("__", "."): {"count": n, "total_ms": ms} for name, (n, ms) in named.items()}


def record(before, after):
    return measures.Record(cell="tiny.streams8", shapes=S, arch=QWEN3_ASR, budget=4, seconds=10.0, setup_s=1.0,
                           requests=[], t_open=0.0, stats_before=before, stats_after=after)


BEFORE = {"spans": spans(scheduler__queue=(4, 400.0), model__decode__step=(10, 250.0),
                         model__decode__sync=(10, 20.0), model__encode=(2, 30.0), model__prefill=(2, 50.0),
                         wire__parse=(4, 4.0), wire__pool_wait=(4, 0.4), wire__audio=(4, 8.0),
                         wire__reply=(4, 2.0))}
AFTER = {"spans": spans(scheduler__queue=(14, 12_400.0), model__decode__step=(49, 1_225.0),
                        model__decode__sync=(49, 98.0), model__encode=(7, 105.0), model__prefill=(7, 200.0),
                        wire__parse=(14, 24.0), wire__pool_wait=(14, 1.4), wire__audio=(14, 38.0),
                        wire__reply=(14, 12.0))}


def test_the_readers_take_the_window_delta():
    rec = record(BEFORE, AFTER)
    read = {name: spec.reader(name, REPO)(rec) for name in NEW}
    assert read["queue_ms.throughput"] == pytest.approx(12_000.0 / 10)
    assert read["decode_step_ms.throughput"] == pytest.approx(975.0 / 39)
    assert read["decode_host_ms.latency"] == read["decode_host_ms.throughput"] == pytest.approx((975.0 - 78.0) / 39)
    assert read["encoder_ms.latency"] == pytest.approx(75.0 / 5)
    assert read["decoder_prefill_ms.latency"] == pytest.approx(150.0 / 5)
    assert read["wire_server_ms.throughput"] == pytest.approx((20.0 + 1.0 + 30.0 + 10.0) / 10)


def test_a_span_first_seen_in_the_window_counts_from_zero():
    before = {"spans": {k: v for k, v in BEFORE["spans"].items() if k != "scheduler.queue"}}
    assert spec.reader("queue_ms.throughput", REPO)(record(before, AFTER)) == pytest.approx(12_400.0 / 14)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("missing", ["before", "after", "both"])
def test_no_spans_in_either_snapshot_reads_nothing(name, missing):
    before = {"transcription_count": 3} if missing in ("before", "both") else BEFORE
    after = {"transcription_count": 9} if missing in ("after", "both") else AFTER
    assert spec.reader(name, REPO)(record(before, after)) is None


@pytest.mark.parametrize("name", NEW)
def test_no_span_of_the_kind_in_the_window_reads_nothing(name):
    assert spec.reader(name, REPO)(record(BEFORE, BEFORE)) is None


def test_decode_step_throughput_reads_its_own_file_not_the_step_lists():
    folder = os.path.join(REPO, "benchmark_torch", "metrics")
    assert os.path.exists(os.path.join(folder, "decode_step_ms.throughput.py"))
    rec = record(BEFORE, AFTER)
    assert spec.reader("decode_step_ms.throughput", REPO)(rec) == pytest.approx(25.0)
    assert spec.reader("decode_step_ms.latency", REPO)(rec) is None  # the list reader: no request carries steps


def test_every_new_metric_is_a_program_span_with_its_cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms" and m["better"] == "lower"
        cell = "qwen3-asr-0.6b.dictation" if name.endswith(".latency") else "qwen3-asr-0.6b.streams8"
        assert m["workloads"] == [cell]
        assert m["moves"] == ("latency_p50_ms" if name.endswith(".latency") else "audio_s_per_s")

"""``decode_replay_share.*`` reads the share of the window's decode steps
that replayed a captured graph, and nothing from an engine that records no
replay span."""

import json
import os

import pytest

from harness import measures, spec

from conftest import QWEN3_ASR, REPO, tiny_config

S = QWEN3_ASR.shapes(tiny_config())
NAMES = ("decode_replay_share.latency", "decode_replay_share.throughput")


def spans(**named):
    return {name.replace("__", "."): {"count": n, "total_ms": ms} for name, (n, ms) in named.items()}


def record(before, after):
    return measures.Record(cell="tiny.dictation", shapes=S, arch=QWEN3_ASR, budget=4, seconds=10.0, setup_s=1.0,
                           requests=[], t_open=0.0, stats_before=before, stats_after=after)


BEFORE = {"spans": spans(model__decode__step=(39, 900.0), model__decode__capture=(1, 30.0),
                         model__decode__replay=(39, 2.0))}
AFTER = {"spans": spans(model__decode__step=(117, 1_200.0), model__decode__capture=(3, 90.0),
                        model__decode__replay=(115, 6.0))}


@pytest.mark.parametrize("name", NAMES)
def test_replays_over_steps_in_the_window(name):
    assert spec.reader(name, REPO)(record(BEFORE, AFTER)) == pytest.approx(100.0 * 76 / 78)
    assert spec.reader(name, REPO)(record({"spans": {}}, AFTER)) == pytest.approx(100.0 * 115 / 117)


@pytest.mark.parametrize("name", NAMES)
def test_an_engine_without_replay_spans_reads_nothing(name):
    """The parent records steps but no replay span: the metric is left out,
    not read as 0; so is a window without a step or without spans."""
    eager = {"spans": spans(model__decode__step=(117, 3_000.0), model__decode__sync=(117, 5.0))}
    assert spec.reader(name, REPO)(record({"spans": {}}, eager)) is None
    assert spec.reader(name, REPO)(record(BEFORE, BEFORE)) is None
    assert spec.reader(name, REPO)(record({"transcription_count": 1}, AFTER)) is None


def test_the_entries_are_program_spans_of_the_model_layer():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    assert entries["decode_replay_share.latency"]["workloads"] == ["qwen3-asr-0.6b.dictation"]
    assert entries["decode_replay_share.throughput"]["workloads"] == ["qwen3-asr-0.6b.streams8"]
    for name in NAMES:
        m = entries[name]
        assert (m["source"], m["unit"], m["better"], m["layer"]) == ("program_span", "%", "higher", "model")

"""Traffic is a function of the mix and the seed, and every seed offers the same sizes."""

import json
import os

import numpy as np

from harness import traffic

from conftest import BENCH


def mix(name="streams8"):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


def test_same_seed_same_traffic_other_seed_other_audio():
    m = mix()
    a, b, c = traffic.generate(m, 2**33 + 5), traffic.generate(m, 2**33 + 5), traffic.generate(m, 2**33 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a.utterances, b.utterances)) and a.orders == b.orders
    assert not any(np.array_equal(x, y) for x, y in zip(a.utterances, c.utterances))
    assert a.orders != c.orders
    assert [len(u) for u in a.utterances] == [len(u) for u in c.utterances]  # same sizes, other content


def test_sizes_follow_the_mix():
    m = mix("dictation")
    t = traffic.generate(m, 11)
    assert len(t.utterances) == m["clips"]
    speech = m["speech_seconds"]["seconds"]
    total = speech + m["lead_silence_seconds"] + m["trail_silence_seconds"]
    assert all(len(u) == round(total * traffic.SAMPLE_RATE) for u in t.utterances)
    assert all(len(u) % traffic.HOP == 0 and u.dtype == np.int16 for u in t.utterances)
    assert t.clients == 1 and len(t.orders) == 1 and sorted(t.orders[0][: m["clips"]]) == list(range(m["clips"]))


def test_a_lognormal_mix_takes_its_quantiles():
    m = {**mix("dictation"), "clips": 16,
         "speech_seconds": {"distribution": "lognormal", "median": 8.0, "sigma": 0.6, "min": 2.0, "max": 30.0}}
    speech = traffic.speech_lengths(m)
    assert len(speech) == 16 and speech == sorted(speech)
    assert min(speech) >= 2.0 and max(speech) <= 30.0 and abs(float(np.median(speech)) - 8.0) < 0.5


def test_clients_share_no_clip_and_never_send_one_twice_in_a_row():
    m = mix()
    t = traffic.generate(m, 3)
    assert t.clients == 8
    mine = [set(order) for order in t.orders]
    assert all(not (a & b) for i, a in enumerate(mine) for b in mine[i + 1:])
    assert set().union(*mine) == set(range(m["clips"]))
    for order in t.orders:
        assert all(x != y for x, y in zip(order, order[1:]))

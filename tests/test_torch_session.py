"""The port's session bridge and pool (``serving/session_bridge.py``,
``serving/session_pool.py``) against the reference's.

The same request sequences go through both packages' bridges and pools on the
tiny GGUF fixture: results, hits, resets, evictions, parked bytes and
``stats()`` must be equal; pinned bridges survive concurrent eviction.
"""

import threading

import numpy as np
import pytest

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
from light_whisper_tpu.serving import session_bridge as ref_bridge
from light_whisper_tpu.serving import session_pool as ref_pool
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel
from light_whisper_tpu_torch.serving import session_bridge as port_bridge
from light_whisper_tpu_torch.serving import session_pool as port_pool

MAX_NEW = 6
SR = 16000


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")
    path = str(tmp_path_factory.mktemp("session") / "tiny.gguf")
    write_tiny_model(path, quantize=True, seed=1)
    try:
        yield RefModel(path, max_new_tokens=MAX_NEW), Qwen3ASRModel(path, device="cpu", max_new_tokens=MAX_NEW)
    finally:
        mp.undo()


def _pcm(seconds, seed):
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.standard_normal(int(seconds * SR)) * 0.3 * 32768), -32768, 32767).astype(np.int16)


def test_constants_match_the_reference():
    assert port_bridge.DEFAULT_PARK_MAX_BYTES == ref_bridge.DEFAULT_PARK_MAX_BYTES
    assert port_pool.DEFAULT_STREAM == ref_pool.DEFAULT_STREAM
    assert port_pool.DEFAULT_MAX_SESSIONS == ref_pool.DEFAULT_MAX_SESSIONS


@pytest.mark.parametrize("value", [None, "3", "0", "junk", "-2"])
def test_env_bounds_match_the_reference(monkeypatch, value):
    for name in ("LWT_SESSION_PARK_MAX_BYTES", "LWT_MAX_SESSIONS"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert port_bridge.park_max_bytes() == ref_bridge.park_max_bytes()
    assert port_pool.max_sessions() == ref_pool.max_sessions()


def test_bridge_hits_and_resets_match_the_reference(models):
    ref, port = models
    a, other = _pcm(6, seed=1), _pcm(3, seed=2)
    sequence = [a[: 3 * SR], a[: 4 * SR], a[: 6 * SR], other, other, a[: 4 * SR]]
    rb, pb = ref_bridge.SessionBridge(ref), port_bridge.SessionBridge(port)
    for audio in sequence:
        want = rb.transcribe_extending(audio)
        got = pb.transcribe_extending(audio)
        assert got.tokens == want.tokens
        assert (pb.session_hits, pb.session_resets) == (rb.session_hits, rb.session_resets)
        assert pb.retained_bytes == rb.retained_bytes == audio.nbytes
    assert (pb.session_hits, pb.session_resets) == (3, 3)
    assert pb._inc.incremental_prefills == rb._inc.incremental_prefills >= 1
    pb.reset()
    assert pb.retained_bytes == 0 and pb._inc._cache is None


def test_park_cap_parks_nothing_over_it(models, monkeypatch):
    _ref, port = models
    monkeypatch.setenv("LWT_SESSION_PARK_MAX_BYTES", str(3 * SR * 2))
    pb = port_bridge.SessionBridge(port)
    a = _pcm(4, seed=3)
    pb.transcribe_extending(a[: 3 * SR])
    assert pb.retained_bytes == 3 * SR * 2
    pb.transcribe_extending(a)  # extends: a hit, but 4 s is over the cap
    assert (pb.session_hits, pb.retained_bytes) == (1, 0)
    pb.transcribe_extending(a)  # nothing parked: the same audio resets
    assert (pb.session_hits, pb.session_resets) == (1, 2)


def _drive_pool(pool, sequence):
    out = []
    for stream, audio in sequence:
        with pool.checkout([stream]) as (bridge,):
            out.append(bridge.transcribe_extending(audio).tokens)
    return out


def test_pool_evicts_lru_keeps_retired_counters_and_matches_the_reference(models):
    ref, port = models
    streams = {name: _pcm(4, seed=10 + i) for i, name in enumerate("abc")}
    sequence = [("a", streams["a"][: 2 * SR]), ("b", streams["b"][: 2 * SR]), ("a", streams["a"][: 3 * SR]),
                ("c", streams["c"][: 2 * SR]),  # limit 2: evicts b, the least recently used
                ("a", streams["a"]), ("b", streams["b"][: 3 * SR]), (None, streams["c"][: 2 * SR])]
    rp, pp = ref_pool.SessionPool(ref, limit=2), port_pool.SessionPool(port, limit=2)
    assert _drive_pool(pp, sequence) == _drive_pool(rp, sequence)
    stats = pp.stats()
    assert stats == rp.stats()
    assert stats["session_evictions"] == 3 and len(pp) == 2
    assert stats["session_hits"] == 2 and stats["session_resets"] == 5
    # every stream with a hit ("a", 2 hits) was evicted: its counters are retired, still counted
    assert set(stats["session_streams"]) == {"b", port_pool.DEFAULT_STREAM}


def test_checkout_pins_a_bridge_against_concurrent_eviction(models):
    _ref, port = models
    pool = port_pool.SessionPool(port, limit=1)
    inside, release = threading.Event(), threading.Event()
    seen = {}

    def hold():
        with pool.checkout(["held"]) as (bridge,):
            seen["bridge"] = bridge
            inside.set()
            release.wait(30)
            seen["after"] = pool.bridge_for("held")

    worker = threading.Thread(target=hold)
    worker.start()
    assert inside.wait(30)
    with pool.checkout(["other"]):
        pass  # over the limit, but "held" is pinned: nothing to evict
    assert pool.evictions == 0 and len(pool) == 2
    release.set()
    worker.join(30)
    assert seen["after"] is seen["bridge"]
    pool.bridge_for("third")  # nothing pinned now: the two oldest go
    assert pool.evictions == 2 and len(pool) == 1
    assert not pool._pinned


def test_concurrent_checkouts_never_evict_a_pinned_bridge():
    """More threads than cores check streams out of a pool of two while new
    streams keep arriving: a checked-out bridge stays in the pool until its
    checkout ends, and the pool is back within its limit after."""
    import sys
    import types

    model = types.SimpleNamespace(max_new_tokens=4,
                                  config=types.SimpleNamespace(audio=types.SimpleNamespace(window_tokens=52)))
    pool = port_pool.SessionPool(model, limit=2)
    lost, errors = [], []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(200):
                key = f"s{int(rng.integers(0, 8))}"
                with pool.checkout([key]) as (bridge,):
                    if pool._bridges.get(key) is not bridge:
                        lost.append(key)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not lost
    assert not pool._pinned
    pool.bridge_for("last")
    assert len(pool) <= 2 and pool.evictions > 0

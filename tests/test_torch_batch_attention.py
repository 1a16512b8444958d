"""The port's unstacked and batched decode attention against the Pallas kernels
(interpret mode) and the reference decoder's batched einsum.

``decode_attention_unstacked`` is held against ``decode_attention_pallas``
and ``decode_attention_batched`` against ``decode_attention_pallas_batched``
and ``decoder._attention_decode_batch``, at streams with mixed positions
whose caches hold large junk past each position (the padded prompt tails
that decode overwrites one slot at a time). Tolerance 5e-3 absolute for the
bf16 rounding of the softmax weights; hd 128, G 2, two layers.
"""

import json
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec
from light_whisper_tpu.ops.decode_attention import decode_attention_pallas, decode_attention_pallas_batched
from light_whisper_tpu_torch.ops import _build
from light_whisper_tpu_torch.ops import decode_attention as da

TOL = 5e-3
L, HQ, HKV, HD = 2, 4, 2, 128
JUNK = 1e4


def _bf16(rng, shape):
    """bf16 values as (jax array, torch tensor) holding the same numbers."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def _batched_case(positions, C, seed):
    """Per-stream caches [B, L, Hkv, C, hd]; every slot past a stream's
    position holds +/-1e4."""
    rng = np.random.default_rng(seed)
    B = len(positions)
    q = (rng.standard_normal((B, HQ, HD)) * 2.0).astype(np.float32)
    k = rng.standard_normal((B, L, HKV, C, HD)).astype(np.float32)
    v = rng.standard_normal((B, L, HKV, C, HD)).astype(np.float32)
    for b, p in enumerate(positions):
        k[b, :, :, p + 1:] = JUNK
        v[b, :, :, p + 1:] = -JUNK
    kj, vj = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
    kt = torch.from_numpy(np.array(kj.astype(jnp.float32))).to(torch.bfloat16)
    vt = torch.from_numpy(np.array(vj.astype(jnp.float32))).to(torch.bfloat16)
    return q, kj, vj, kt, vt


@pytest.mark.parametrize("T,start", [(1, 0), (1, 255), (4, 100), (8, 37), (64, 150)])
def test_unstacked_matches_pallas(T, start):
    rng = np.random.default_rng(T + start)
    q = (rng.standard_normal((T, HQ, HD)) * 2.0).astype(np.float32)
    kj, kt = _bf16(rng, (HKV, 256, HD))
    vj, vt = _bf16(rng, (HKV, 256, HD))
    pos = jnp.arange(T, dtype=jnp.int32) + start
    want = np.asarray(decode_attention_pallas(jnp.asarray(q), kj, vj, pos, interpret=True))
    got = da.decode_attention_unstacked(torch.from_numpy(q), kt, vt, start)
    assert got.shape == (T, HQ, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("positions,C", [([0, 37], 128), ([5, 127, 64], 128),
                                         ([0, 37, 511, 1023, 3, 200, 700, 1000], 1024)])
def test_batched_matches_pallas_batched(positions, C):
    q, kj, vj, kt, vt = _batched_case(positions, C, seed=len(positions))
    pos = torch.tensor(positions, dtype=torch.int32)
    for layer in range(L):
        want = np.asarray(decode_attention_pallas_batched(
            jnp.asarray(q), kj, vj, jnp.asarray(positions, jnp.int32), jnp.int32(layer), interpret=True))
        got = da.decode_attention_batched(torch.from_numpy(q), kt, vt, pos, layer, positions)
        assert got.shape == (len(positions), HQ, HD) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_batched_matches_reference_decode_batch(dtype):
    """The reference decoder's ``_attention_decode_batch`` (the XLA path the
    batched decode takes by default), at bf16 and at precise-mode f32."""
    positions = [3, 90, 0, 127]
    q, kj, vj, kt, vt = _batched_case(positions, 128, seed=11)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = np.asarray(ref_dec._attention_decode_batch(
        jnp.asarray(q), kj[:, 1].astype(jdt), vj[:, 1].astype(jdt), jnp.asarray(positions, jnp.int32), 2, jdt
    ).astype(jnp.float32)).reshape(len(positions), HQ, HD)
    got = da.decode_attention_batched_plain(torch.from_numpy(q), kt.to(tdt), vt.to(tdt),
                                            torch.tensor(positions), 1, tdt)
    # the reference returns q's dtype (f32 here); bf16 weights round as in the kernel
    np.testing.assert_allclose(got.numpy(), want, atol=TOL if dtype == "bfloat16" else 1e-5, rtol=0)


@pytest.mark.parametrize("splits", [1, 2, 3, 16])
def test_batched_split_plain_matches_pallas_batched(splits):
    """The kernel's split schedule a (stream, KV head) against the Pallas kernel,
    with +/-1e4 junk past each position; the stream at 0 has one live key, so
    most of its splits are empty."""
    C = 128
    positions = [0, 37, C - 1]
    q, kj, vj, kt, vt = _batched_case(positions, C, seed=20 + splits)
    want = np.asarray(decode_attention_pallas_batched(
        jnp.asarray(q), kj, vj, jnp.asarray(positions, jnp.int32), jnp.int32(1), interpret=True))
    got = da.decode_attention_batched_split_plain(torch.from_numpy(q), kt, vt, torch.tensor(positions), 1, splits)
    assert got.shape == (len(positions), HQ, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_each_stream_sees_only_its_own_live_keys():
    positions = [10, 40, 25]
    q, _, _, kt, vt = _batched_case(positions, 64, seed=3)
    qt, pos = torch.from_numpy(q), torch.tensor(positions, dtype=torch.int32)
    base = da.decode_attention_batched(qt, kt, vt, pos, 0, positions)
    # past each position: other junk changes nothing
    kt2, vt2 = kt.clone(), vt.clone()
    for b, p in enumerate(positions):
        kt2[b, 0, :, p + 1:] = -3e4
        vt2[b, 0, :, p + 1:] = 5e3
    torch.testing.assert_close(da.decode_attention_batched(qt, kt2, vt2, pos, 0, positions), base)
    # a live key of stream 1 moves stream 1 only
    vt2[1, 0, :, 7] += 4.0
    moved = da.decode_attention_batched(qt, kt2, vt2, pos, 0, positions)
    torch.testing.assert_close(moved[[0, 2]], base[[0, 2]])
    assert not torch.allclose(moved[1], base[1])


def test_batched_refuses_positions_past_the_cache():
    _, _, _, kt, vt = _batched_case([1, 2], 32, seed=0)
    q = torch.zeros(2, HQ, HD)
    with pytest.raises(ValueError, match="exceed"):
        da.decode_attention_batched(q, kt, vt, torch.tensor([1, 32], dtype=torch.int32), 0, [1, 32])
    with pytest.raises(ValueError, match="layer"):
        da.decode_attention_batched(q, kt, vt, torch.tensor([1, 2], dtype=torch.int32), L, [1, 2])


def test_cpu_calls_launch_nothing():
    before = dict(da.LAUNCHES)
    _, _, _, kt, vt = _batched_case([3, 4], 32, seed=1)
    da.decode_attention_batched(torch.zeros(2, HQ, HD), kt, vt, torch.tensor([3, 4]), 0, [3, 4])
    da.decode_attention_unstacked(torch.zeros(2, HQ, HD), kt[0, 0], vt[0, 0], 5)
    assert da.LAUNCHES == before
    assert set(da.LAUNCHES) == {"decode_attention", "decode_attention_unstacked", "decode_attention_batched"}


def test_other_devices_are_refused():
    q = torch.zeros((2, HQ, HD), device="meta")
    kc = torch.zeros((2, L, HKV, 16, HD), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention_batched(q, kc, kc, torch.zeros(2, dtype=torch.int32), 0, [0, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention_unstacked(q, kc[0, 0], kc[0, 0], 0)


FAKE_NVCC = r"""
import json, os, sys, time
log = os.environ["FAKE_NVCC_LOG"]
with open(log, "a") as f:
    t0 = time.time()
    time.sleep(1.0)
    f.write(json.dumps({"argv": sys.argv[1:], "t0": t0, "t1": time.time()}) + "\n")
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "w").write("fake")
if os.path.basename(sys.argv[-1]) == os.environ.get("FAKE_NVCC_FAIL"):
    sys.exit(1)
"""


def test_each_source_compiles_in_its_own_nvcc_all_at_once(monkeypatch, tmp_path):
    """One ``nvcc -c`` per source, all started before any is waited on, then
    one link: the build costs the slowest source, not the sum."""
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\n{FAKE_NVCC}")
    script.chmod(0o755)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    lib = _build.build()
    assert lib.is_file() and lib.name == _build.LIB_NAME
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c["argv"]]
    links = [c for c in calls if "-shared" in c["argv"]]
    sources = sorted(os.path.basename(c["argv"][-1]) for c in compiles)
    assert sources == [p.name for p in _build.sources()]
    assert len(links) == 1
    # every compile was running while every other one was
    assert max(c["t0"] for c in compiles) < min(c["t1"] for c in compiles)
    assert links[0]["t0"] >= max(c["t1"] for c in compiles)
    assert [p.name for p in lib.parent.iterdir()] == [_build.LIB_NAME]  # objects removed
    assert _build.build() == lib  # an unchanged source set is reused
    assert len(log.read_text().splitlines()) == len(calls)


def test_a_failed_compile_leaves_no_objects(monkeypatch, tmp_path):
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\n{FAKE_NVCC}")
    script.chmod(0o755)
    failing = _build.sources()[0].name
    monkeypatch.setenv("FAKE_NVCC_LOG", str(tmp_path / "calls.jsonl"))
    monkeypatch.setenv("FAKE_NVCC_FAIL", failing)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    with pytest.raises(RuntimeError, match=f"nvcc failed on \\['{failing}'\\]"):
        _build.build()
    assert [p.name for p in (tmp_path / "kernels").rglob("*") if p.is_file()] == []

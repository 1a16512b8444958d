"""Port Q8_0 matmul (all three forms) against the Pallas kernels in interpret mode.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX side
runs ``q8_matmul_pallas*`` with ``interpret=True`` as tests/test_q8_matmul.py
does. Integer-valued inputs match bitwise; otherwise rtol=atol=1e-4 (sum
order only), and the fused residual output within one bf16 ulp of
max(|acc|, |out|) (bf16(acc) may round one ulp apart; 1e-3 of max|acc| more
with the norm prologue). The CUDA kernel's own tests are in
tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from light_whisper_tpu.formats.gguf import quantize_q8_0
from light_whisper_tpu.ops.q8_matmul import (
    q8_matmul_pallas,
    q8_matmul_pallas_stacked,
    q8_matmul_pallas_stacked_fused,
)
from light_whisper_tpu_torch.models.qwen3_asr.loader import to_bf16
from light_whisper_tpu_torch.ops import linear, q8_matmul as q8

RTOL = ATOL = 1e-4


def _weights(L, out_f, in_f, seed):
    rng = np.random.default_rng(seed)
    qs, ss = zip(*(quantize_q8_0((rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)).astype(np.float32))
                   for _ in range(L)))
    return np.stack(qs), np.stack(ss)  # int8 [L, out, in], f16 [L, out, in/32]


def _bf16_np(x):
    """Round f32 → bf16 exactly as the port does, back to f32 numpy."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _port(q, s):
    return torch.from_numpy(q), to_bf16(s)


def _bf16_ulp(v):
    mag = np.maximum(np.abs(v), 1e-30)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("T,out_f,in_f", [(1, 256, 512), (8, 512, 1024), (64, 256, 512), (200, 384, 512)])
def test_2d_matches_pallas(T, out_f, in_f):
    q, s = _weights(1, out_f, in_f, seed=T)
    x = np.random.default_rng(T + 1).standard_normal((T, in_f)).astype(np.float32)
    want = np.asarray(q8_matmul_pallas(jnp.asarray(x), jnp.asarray(q[0]), jnp.asarray(s[0]), interpret=True))
    qt, st = _port(q[0], s[0])
    got = q8.q8_matmul(torch.from_numpy(x), qt, st).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T", [1, 8, 64])
def test_stacked_matches_pallas_on_each_layer(T):
    q, s = _weights(3, 256, 512, seed=7)
    x = jnp.asarray(np.random.default_rng(8).standard_normal((T, 512)).astype(np.float32)).astype(jnp.bfloat16)
    s_t = jnp.asarray(s).astype(jnp.bfloat16).transpose(0, 2, 1)
    qt, st = _port(q, s)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    for layer in range(3):
        want = np.asarray(q8_matmul_pallas_stacked(x, jnp.asarray(q), s_t, jnp.int32(layer), interpret=True))
        got = q8.q8_matmul_stacked(xt, qt, st, layer).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "with_norm,with_residual", [(True, False), (False, True), (True, True)], ids=["norm", "residual", "both"]
)
@pytest.mark.parametrize("T", [1, 4])
def test_stacked_fused_matches_pallas(T, with_norm, with_residual):
    out_f, in_f = 512, 512
    q, s = _weights(2, out_f, in_f, seed=11)
    rng = np.random.default_rng(12)
    x = _bf16_np(rng.standard_normal((T, in_f)))
    norm_w = (1.0 + 0.1 * rng.standard_normal(in_f)).astype(np.float32) if with_norm else None
    res = _bf16_np(rng.standard_normal((T, out_f))) if with_residual else None
    s_t = jnp.asarray(s).astype(jnp.bfloat16).transpose(0, 2, 1)
    want = np.asarray(
        q8_matmul_pallas_stacked_fused(
            jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q), s_t, jnp.int32(1),
            norm_w=None if norm_w is None else jnp.asarray(norm_w), eps=1e-6,
            residual=None if res is None else jnp.asarray(res), interpret=True,
        )
    )
    qt, st = _port(q, s)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    nt = None if norm_w is None else torch.from_numpy(norm_w)
    rt = None if res is None else torch.from_numpy(res).to(torch.bfloat16)
    got = q8.q8_matmul_stacked_fused(xt, qt, st, 1, norm_w=nt, eps=1e-6, residual=rt).numpy()
    if with_residual:
        acc = q8.q8_matmul_stacked_fused(xt, qt, st, 1, norm_w=nt, eps=1e-6).numpy()
        ulp = _bf16_ulp(np.maximum(np.abs(want), np.abs(acc)))
        # with the norm prologue too, the rsqrt scale summed in another order
        # may move one normalised input by a bf16 ulp: 1e-3 of max|acc| more
        slack = 1e-3 * max(1.0, np.abs(acc).max()) if with_norm else 0.0
        assert np.all(np.abs(got - want) <= ulp * 1.0001 + slack), np.max(np.abs(got - want) / ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("form", ["2d", "stacked", "fused_residual"])
def test_integer_valued_inputs_are_bitwise(form):
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 127, size=(2, 256, 512), dtype=np.int8)
    s = np.full((2, 256, 512 // 32), 0.5, dtype=np.float16)
    x = rng.integers(-4, 4, size=(8, 512)).astype(np.float32)
    qt, st = _port(q, s)
    xt = torch.from_numpy(x)
    s_t = jnp.asarray(s).astype(jnp.bfloat16).transpose(0, 2, 1)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    if form == "2d":
        want = np.asarray(q8_matmul_pallas(xj, jnp.asarray(q[0]), jnp.asarray(s[0]), interpret=True))
        got = q8.q8_matmul(xt, qt[0], st[0]).numpy()
        np.testing.assert_array_equal(want, x @ (q[0].astype(np.float32) * 0.5).T)
    elif form == "stacked":
        want = np.asarray(q8_matmul_pallas_stacked(xj, jnp.asarray(q), s_t, jnp.int32(1), interpret=True))
        got = q8.q8_matmul_stacked(xt, qt, st, 1).numpy()
    else:
        # The kernel's accumulator is compared bitwise; its epilogue
        # bf16(res) + bf16(acc) is then rounded eagerly, because XLA on the CPU
        # keeps excess f32 precision through the interpret-mode epilogue
        # (the sum comes back unrounded there).
        res = rng.integers(-64, 64, size=(8, 256)).astype(np.float32)
        acc = np.asarray(q8_matmul_pallas_stacked_fused(xj, jnp.asarray(q), s_t, jnp.int32(1), interpret=True))
        np.testing.assert_array_equal(
            q8.q8_matmul_stacked_fused(xt.to(torch.bfloat16), qt, st, 1).numpy(), acc)
        want = np.asarray(
            (jnp.asarray(res).astype(jnp.bfloat16) + jnp.asarray(acc).astype(jnp.bfloat16)).astype(jnp.float32))
        got = q8.q8_matmul_stacked_fused(xt.to(torch.bfloat16), qt, st, 1,
                                         residual=torch.from_numpy(res).to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dequantize_rounds_like_the_reference():
    """bf16(q·s) — the rounding q8_matmul_xla applies (bf16 × bf16 product)."""
    from light_whisper_tpu.ops.linear import q8_matmul_xla

    q, s = _weights(1, 64, 256, seed=3)
    x = np.eye(256, dtype=np.float32)
    want = np.asarray(q8_matmul_xla(jnp.asarray(x), jnp.asarray(q[0]), jnp.asarray(s[0]).astype(jnp.bfloat16))).T
    qt, st = _port(q[0], s[0])
    np.testing.assert_array_equal(q8.dequantize(qt, st).float().numpy(), want)


def test_apply_linear_dense_and_q8_with_bias():
    from light_whisper_tpu.ops.linear import apply_linear as ref_linear

    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    q, s = quantize_q8_0(w.T.copy())
    dense_ref = np.asarray(ref_linear({"w": jnp.asarray(w).astype(jnp.bfloat16), "b": jnp.asarray(b)},
                                      jnp.asarray(x).astype(jnp.bfloat16)))
    dense = linear.apply_linear({"w": torch.from_numpy(w).to(torch.bfloat16), "b": torch.from_numpy(b)},
                                torch.from_numpy(x).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(dense, dense_ref, rtol=RTOL, atol=ATOL)
    q8_ref = np.asarray(ref_linear({"q": jnp.asarray(q), "s": jnp.asarray(s).astype(jnp.bfloat16),
                                    "b": jnp.asarray(b)}, jnp.asarray(x)))
    qt, st = _port(q, s)
    got = linear.apply_linear({"q": qt, "s": st, "b": torch.from_numpy(b)}, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, q8_ref, rtol=RTOL, atol=ATOL)


def test_wrappers_refuse_devices_they_do_not_serve():
    """A tensor that is neither on the CPU nor on a CUDA card is refused, not
    quietly computed with the plain version."""
    q = torch.zeros((2, 64, 64), dtype=torch.int8, device="meta")
    s = torch.zeros((2, 64, 2), dtype=torch.bfloat16, device="meta")
    x = torch.zeros((1, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        q8.q8_matmul(x, q[0], s[0])
    with pytest.raises(ValueError, match="unsupported device"):
        q8.q8_matmul_stacked(x, q, s, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        q8.q8_matmul_stacked_fused(x, q, s, 0)


def test_fused_form_takes_decode_rows_only():
    q = torch.zeros((1, 64, 64), dtype=torch.int8)
    s = torch.zeros((1, 64, 2), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        q8.q8_matmul_stacked_fused(torch.zeros((9, 64)), q, s, 0)


def test_cpu_path_does_not_count_launches():
    before = dict(q8.LAUNCHES)
    q = torch.zeros((64, 64), dtype=torch.int8)
    s = torch.zeros((64, 2), dtype=torch.bfloat16)
    q8.q8_matmul(torch.zeros((2, 64)), q, s)
    assert q8.LAUNCHES == before


def test_build_lists_every_kernel_source_and_needs_nvcc(monkeypatch, tmp_path):
    from light_whisper_tpu_torch.ops import _build

    names = [p.name for p in _build.sources()]
    assert names == [
        "decode_attention.cu", "flash_prefill.cu", "fused_ffn.cu", "q8_matmul.cu", "q8_probe.cu",
    ]
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "kernels").exists()  # nothing is created before a compiler is found



# -- the kernel's K-split schedule (q8_matmul_split_plain) and its chooser -------

# Qwen3-ASR 0.6B's Q8 shapes (N, K): decoder qkv, o, gateup, down, logits head;
# encoder fc1, fc2, conv_out, and its square projections. The values are the
# tile kernel's split counts, as chip_smoke.py prints them on each case.
TILE_SPLITS_06B = {
    (4096, 1024): 2, (1024, 2048): 8, (6144, 1024): 2, (1024, 3072): 8, (152576, 1024): 1,
    (3584, 896): 2, (896, 3584): 8, (896, 7680): 8, (896, 896): 2,
}


def test_tile_splits_is_a_function_of_n_and_k_only():
    import inspect

    assert list(inspect.signature(q8.tile_splits).parameters) == ["N", "K"]
    assert {shape: q8.tile_splits(*shape) for shape in TILE_SPLITS_06B} == TILE_SPLITS_06B
    for T in (9, 64, 192, 3968, 6656):
        for (N, K), splits in TILE_SPLITS_06B.items():
            assert q8.schedule_splits(T, N, K) == splits
    for T in range(1, 9):
        assert q8.schedule_splits(T, 4096, 1024) == q8.GEMV_SPLITS


@pytest.mark.parametrize("N", [8, 64, 100, 896, 1024, 4096, 6144, 152576])
@pytest.mark.parametrize("K", [32, 64, 96, 512, 896, 1024, 2048, 3072, 3584, 7680])
def test_tile_splits_keeps_whole_chunks_in_every_split(N, K):
    splits = q8.tile_splits(N, K)
    assert splits in (1, 2, 4, 8)
    bounds = q8.split_bounds(K, splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(hi == lo2 for (_lo, hi), (lo2, _hi) in zip(bounds, bounds[1:]))
    if splits > 1:
        assert min(hi - lo for lo, hi in bounds) >= q8.MIN_SPLIT_CHUNKS * q8.CHUNK
        assert -(-N // q8.TILE_N) * splits <= q8.FILL_CTAS


def test_chip_smoke_prints_the_chooser_values(monkeypatch):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(q8, "resident_clusters", lambda N, K: 7)  # the card's answer; no card here
    for (N, K), splits in TILE_SPLITS_06B.items():
        assert smoke.q8_schedule(64, N, K) == f"[tile 64x128, S={splits}, 7 clusters resident]"
        assert smoke.q8_schedule(1, N, K) == f"[GEMV, S={q8.GEMV_SPLITS}]"


@pytest.mark.parametrize("T,N,K", [(1, 4096, 1024), (8, 1024, 3072), (9, 1024, 2048), (64, 896, 896),
                                   (64, 6144, 1024), (13, 896, 7680), (20, 896, 3584), (3, 152576 // 64, 1024)])
def test_split_plain_matches_plain_and_pallas(T, N, K):
    """The split schedule at the kernel's S for T rows against the unsplit
    plain version and the JAX reference (1e-4 of max|ref|): the Pallas kernel
    in interpret mode where its K tiles (multiples of 512), else the XLA
    product the JAX package takes for such K (the encoder's 896)."""
    from light_whisper_tpu.ops.linear import q8_matmul_xla

    q, s = _weights(1, N, K, seed=N + K)
    x = _bf16_np(np.random.default_rng(T).standard_normal((T, K)))
    qt, st = _port(q[0], s[0])
    splits = q8.schedule_splits(T, N, K)
    got = q8.q8_matmul_split_plain(torch.from_numpy(x), qt, st, splits).numpy()
    plain = q8.q8_matmul_plain(torch.from_numpy(x), qt, st).numpy()
    if K % 512 == 0:
        want = np.asarray(q8_matmul_pallas(jnp.asarray(x), jnp.asarray(q[0]), jnp.asarray(s[0]), interpret=True))
    else:
        want = np.asarray(q8_matmul_xla(jnp.asarray(x), jnp.asarray(q[0]), jnp.asarray(s[0]).astype(jnp.bfloat16)))
    for ref in (plain, want):
        assert got.shape == ref.shape and got.dtype == np.float32
        assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("K", [1024, 1056, 3072])
def test_split_plain_is_bitwise_on_integer_values(splits, K):
    """Integer-valued inputs: every split count (empty splits and a ragged
    last chunk included) equals the plain version and the JAX reference
    bitwise (the stacked Pallas kernel; XLA's product at K = 1056, which
    the Pallas kernel does not tile)."""
    from light_whisper_tpu.ops.linear import q8_matmul_xla

    rng = np.random.default_rng(K + splits)
    q = rng.integers(-127, 128, size=(2, 96, K), dtype=np.int8)
    s = np.full((2, 96, K // 32), 0.5, dtype=np.float16)
    x = rng.integers(-4, 4, size=(12, K)).astype(np.float32)
    qt, st = _port(q, s)
    got = q8.q8_matmul_split_plain(torch.from_numpy(x), qt[1], st[1], splits).numpy()
    np.testing.assert_array_equal(got, q8.q8_matmul_plain(torch.from_numpy(x), qt[1], st[1]).numpy())
    if K % 512 == 0:
        s_t = jnp.asarray(s).astype(jnp.bfloat16).transpose(0, 2, 1)
        want = np.asarray(q8_matmul_pallas_stacked(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q), s_t,
                                                   jnp.int32(1), interpret=True))
    else:
        want = np.asarray(q8_matmul_xla(jnp.asarray(x), jnp.asarray(q[1]), jnp.asarray(s[1]).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_norm,with_residual", [(True, False), (False, True), (True, True)],
                         ids=["norm", "residual", "both"])
@pytest.mark.parametrize("T,N,K", [(1, 4096, 1024), (8, 1024, 3072), (5, 1024, 2048)])
def test_fused_split_plain_matches_pallas(T, N, K, with_norm, with_residual):
    """The fused form at the GEMV's split count against the fused Pallas
    kernel in interpret mode, under the fused tolerances of the module's
    other tests."""
    q, s = _weights(2, N, K, seed=T + N)
    rng = np.random.default_rng(T)
    x = _bf16_np(rng.standard_normal((T, K)))
    norm_w = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32) if with_norm else None
    res = _bf16_np(rng.standard_normal((T, N))) if with_residual else None
    s_t = jnp.asarray(s).astype(jnp.bfloat16).transpose(0, 2, 1)
    want = np.asarray(q8_matmul_pallas_stacked_fused(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q), s_t, jnp.int32(1),
        norm_w=None if norm_w is None else jnp.asarray(norm_w), eps=1e-6,
        residual=None if res is None else jnp.asarray(res), interpret=True))
    qt, st = _port(q, s)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    nt = None if norm_w is None else torch.from_numpy(norm_w)
    rt = None if res is None else torch.from_numpy(res).to(torch.bfloat16)
    got = q8.q8_matmul_fused_plain(xt, qt[1], st[1], nt, 1e-6, rt, splits=q8.GEMV_SPLITS).numpy()
    if with_residual:
        acc = q8.q8_matmul_fused_plain(xt, qt[1], st[1], nt, 1e-6, None, splits=q8.GEMV_SPLITS).numpy()
        ulp = _bf16_ulp(np.maximum(np.abs(want), np.abs(acc)))
        slack = 1e-3 * max(1.0, np.abs(acc).max()) if with_norm else 0.0
        assert np.all(np.abs(got - want) <= ulp * 1.0001 + slack), np.max(np.abs(got - want) / ulp)
    else:
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())

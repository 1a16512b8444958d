"""The port's Q8 probe entry points against the reference's probe scripts.

``scripts/exp_q8_kperm_probe.py`` is loaded with ``importlib`` (it is a
script, not a module of the package); its Pallas kernels run with
``interpret=True``. ``scripts/exp_q8_compute_bound.py`` sets a compilation
cache at import, so its ``noscale`` and ``dma`` kernel bodies (``:85-99``,
``:221-233``) are restated in numpy here instead. Tolerances:

- permute / unpermute / the permuted scales: exact (index moves);
- the permuted product against the reference kernel in interpret mode:
  1e-5 of max|ref| at 8 rows (the same bf16 products, summed in another
  order);
- ``noscale``: 1e-5 of max|ref| against the numpy body (integer weights,
  bf16 activations, f32 sums); ``load``: bitwise (integer sums).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_whisper_tpu_torch.ops.q8_matmul import q8_matmul_plain
from light_whisper_tpu_torch.scripts import _probe
from light_whisper_tpu_torch.scripts import exp_q8_compute_bound as cb
from light_whisper_tpu_torch.scripts import exp_q8_kperm_probe as kp

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("exp_q8_kperm_probe_ref", REPO / "scripts" / "exp_q8_kperm_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _q8(rng, L, out_f, in_f):
    q = rng.integers(-127, 127, size=(L, out_f, in_f), dtype=np.int8)
    s = (rng.random((L, out_f, in_f // 32), dtype=np.float32) * 0.01 + 0.001).astype(np.float32)
    return q, s


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("block_k", [32, 512, 2048])
def test_permutations_match_the_reference(ref, block_k):
    rng = np.random.default_rng(block_k)
    a = rng.standard_normal((3, 4096)).astype(np.float32)
    p = kp.permute_kaxis(a, block_k)
    np.testing.assert_array_equal(p, np.asarray(ref.permute_kaxis(jnp.asarray(a), block_k)))
    np.testing.assert_array_equal(kp.unpermute_kaxis(p, block_k), a)
    np.testing.assert_array_equal(kp.unpermute_kaxis(a, block_k),
                                  np.asarray(ref.unpermute_kaxis(jnp.asarray(a), block_k)))
    t = torch.from_numpy(a)
    assert torch.equal(kp.permute_kaxis(t, block_k), torch.from_numpy(p))
    s = rng.random((2, 4096 // 32), dtype=np.float32)
    want = np.asarray(ref.expand_scales_perm(jnp.asarray(s), block_k))
    np.testing.assert_array_equal(kp.expand_scales_perm(s, block_k), want)
    np.testing.assert_array_equal(kp.expand_scales_perm(torch.from_numpy(s), block_k).numpy(), want)


def test_permuted_dequant_is_exact():
    """The reference's self-test checks, through the port's CPU self-test."""
    kp.selftest("cpu")
    kp.main(["--selftest", "--device", "cpu"])


@pytest.mark.parametrize("block_k", [512, 1024])
def test_perm_plain_matches_the_reference_kernels(ref, block_k):
    rng = np.random.default_rng(3)
    L, out_f, in_f, T = 2, 256, 1024, 8
    q, s = _q8(rng, L, out_f, in_f)
    qp = np.ascontiguousarray(kp.permute_kaxis(q, block_k))
    x = rng.standard_normal((T, in_f)).astype(np.float32)
    xp = kp.permute_kaxis(_bf16(x), block_k)
    s_bf = jnp.asarray(s).astype(jnp.bfloat16)
    st = torch.from_numpy(np.asarray(s_bf.astype(jnp.float32))).to(torch.bfloat16)
    for layer in range(L):
        want = np.asarray(ref._q8_matmul_perm_2d(jnp.asarray(xp), jnp.asarray(qp[layer]), s_bf[layer], 8, 128,
                                                 block_k, interpret=True))
        got = kp.q8_matmul_perm_2d(torch.from_numpy(xp), torch.from_numpy(qp[layer]), st[layer], block_k).numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
        want_stacked = np.asarray(ref._q8_matmul_stacked_perm_2d(
            jnp.asarray(xp), jnp.asarray(qp), s_bf.transpose(0, 2, 1), jnp.int32(layer), 8, 128, block_k,
            interpret=True))
        got_stacked = kp.q8_matmul_stacked_perm_2d(torch.from_numpy(xp), torch.from_numpy(qp), st, layer,
                                                   block_k).numpy()
        assert np.abs(got_stacked - want_stacked).max() <= 1e-5 * scale
        # and the natural product, with x permuted inside the call
        natural = q8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q[layer]), st[layer]).numpy()
        got_nat = kp.q8_matmul_perm(torch.from_numpy(x), torch.from_numpy(qp[layer]), st[layer], block_k).numpy()
        assert np.abs(got_nat - natural).max() <= 1e-5 * scale


def _noscale_body(x, q, block_o, block_k):
    """``_body_noscale``: acc += bf16(x) · bf16(q)ᵀ over k blocks, per output tile."""
    T, K = x.shape
    N = q.shape[0]
    out = np.zeros((T, N), np.float32)
    for o in range(0, N, block_o):
        for k in range(0, K, block_k):
            out[:, o : o + block_o] += _bf16(x[:, k : k + block_k]) @ q[o : o + block_o, k : k + block_k].T.astype(
                np.float32)
    return out


def _dma_body(q, T, block_o, block_k):
    """``_body_dma``: per output tile o, ``acc[:, :m] += q_block[:T, :m]`` over k
    blocks, m = min(block_o, block_k); the rest of the tile stays 0."""
    N, K = q.shape
    out = np.zeros((T, N), np.float32)
    m = min(block_o, block_k)
    for o in range(0, N, block_o):
        for k in range(0, K, block_k):
            out[:, o : o + m] += q[o : o + T, k : k + m].astype(np.float32)
    return out


@pytest.mark.parametrize("T,out_f,in_f", [(1, 256, 1024), (8, 1024, 3072), (8, 300, 512)])
def test_noscale_and_load_plain_are_the_reference_bodies(T, out_f, in_f):
    """The port's schedule is one output tile of all ``out`` rows, so its
    ``load`` is the reference's ``dma`` body at ``block_o = out``."""
    rng = np.random.default_rng(out_f)
    q, s = _q8(rng, 1, out_f, in_f)
    x = rng.standard_normal((T, in_f)).astype(np.float32)
    xt, qt, st = torch.from_numpy(x), torch.from_numpy(q[0]), torch.from_numpy(s[0]).to(torch.bfloat16)
    want = _noscale_body(x, q[0], 128, cb.LOAD_BLOCK_K)
    got = cb.q8_probe("noscale", xt, qt, st).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(cb.q8_probe("load", xt, qt, st).numpy(),
                                  _dma_body(q[0], T, out_f, cb.LOAD_BLOCK_K))


def test_the_expand_matmul_variants_run_the_kernels_that_answer_them():
    """``subexpand`` is ``full`` and ``repeatcost`` is ``permexact`` here; the
    permuted product equals the natural one."""
    rng = np.random.default_rng(5)
    q, s = _q8(rng, 2, 512, 1024)
    qt, st = torch.from_numpy(q), torch.from_numpy(s).to(torch.bfloat16)
    qp = kp.permute_kaxis(qt, cb.PERM_BLOCK_K).contiguous()
    x = torch.randn(4, 1024).to(torch.bfloat16)
    full = cb.run_variant("full", x, qt, st, 1)
    assert torch.equal(cb.run_variant("subexpand", x, qt, st, 1), full)
    perm = cb.run_variant("permexact", x, qp, st, 1)
    assert torch.equal(cb.run_variant("repeatcost", x, qp, st, 1), perm)
    torch.testing.assert_close(perm, full, rtol=1e-5, atol=1e-5 * float(full.abs().max()))
    assert set(cb.VARIANTS) == {"load", "noscale", "full", "permexact", *cb.SAME_KERNEL}


def test_cpu_calls_count_no_launches_and_refuse_unknown_variants():
    before = dict(cb.LAUNCHES), dict(kp.LAUNCHES)
    q = torch.zeros((64, 512), dtype=torch.int8)
    s = torch.zeros((64, 16), dtype=torch.bfloat16)
    x = torch.zeros((2, 512))
    cb.q8_probe("noscale", x, q, s)
    cb.q8_probe("load", x, q, s)
    kp.q8_matmul_perm(x, q, s, 512)
    assert (dict(cb.LAUNCHES), dict(kp.LAUNCHES)) == before
    with pytest.raises(ValueError, match="unknown probe variant"):
        cb.q8_probe("dma", x, q, s)


def test_probe_bytes_and_the_timed_entry_points_need_a_card(monkeypatch):
    assert _probe.q8_weight_bytes(6144, 1024) == 6144 * 1024 + 6144 * 32 * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _probe.require_card("cuda")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cb.main([])
    with pytest.raises(SystemExit, match="times the card"):
        cb.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="times the card"):
        kp.bench("cpu")

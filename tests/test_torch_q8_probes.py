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
  bf16 activations, f32 sums); ``load``: bitwise (integer sums);
- the GEMV's schedule in torch (``noscale_split_plain``,
  ``q8_matmul_perm_split_plain``: four K splits summed in rank order) against
  the plain versions and the reference bodies: 1e-5 of max|ref| (the same
  exact products, f32 sums in another order).

The probe kernels are instantiations of the shipped GEMV's body; a scan of
the CUDA sources keeps them so.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_whisper_tpu_torch.ops.q8_matmul import GEMV_SPLITS, q8_matmul_plain, split_bounds
from light_whisper_tpu_torch.scripts import _probe
from light_whisper_tpu_torch.scripts import exp_q8_compute_bound as cb
from light_whisper_tpu_torch.scripts import exp_q8_kperm_probe as kp

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "light_whisper_tpu_torch" / "csrc"


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


# -- the GEMV's schedule in torch: four K splits of 64-wide chunks, summed in rank order


def _within(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("T,out_f,in_f", [(1, 300, 512), (8, 300, 3072), (12, 256, 512), (8, 1024, 3072)])
def test_noscale_split_plain_holds_to_the_plain_version_and_the_reference_body(T, out_f, in_f):
    """N = 300 ends in a partial group of 8 rows; K = 512 gives each of the
    four warps two chunks; T = 12 takes two row groups of 8."""
    rng = np.random.default_rng(T * out_f + in_f)
    q, _ = _q8(rng, 1, out_f, in_f)
    x = rng.standard_normal((T, in_f)).astype(np.float32)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q[0])
    got = cb.noscale_split_plain(xt, qt)
    assert got.dtype == torch.float32 and got.shape == (T, out_f)
    _within(got.numpy(), cb.noscale_plain(xt, qt).numpy())
    _within(got.numpy(), _noscale_body(x, q[0], 128 if out_f % 128 == 0 else out_f, cb.LOAD_BLOCK_K))
    # integer-valued activations: every partial sum is exact, so the split order cannot show
    xi = torch.from_numpy(rng.integers(-4, 4, size=(T, in_f)).astype(np.float32))
    assert torch.equal(cb.noscale_split_plain(xi, qt), cb.noscale_plain(xi, qt))


def test_split_bounds_cut_whole_chunks_over_the_four_warps():
    assert GEMV_SPLITS == 4
    assert split_bounds(512, GEMV_SPLITS) == [(0, 128), (128, 256), (256, 384), (384, 512)]
    assert split_bounds(3072, GEMV_SPLITS) == [(0, 768), (768, 1536), (1536, 2304), (2304, 3072)]
    # K = 1056: 17 chunks, the last one half; warps take 4, 4, 4 and 5 chunks
    assert split_bounds(1056, GEMV_SPLITS) == [(0, 256), (256, 512), (512, 768), (768, 1056)]


@pytest.mark.parametrize("T,out_f,in_f,block_k", [(1, 300, 512, 512), (8, 300, 3072, 512), (12, 256, 2048, 2048),
                                                  (8, 300, 4096, 2048)])
def test_perm_split_plain_holds_to_the_plain_version_and_the_reference_kernel(ref, T, out_f, in_f, block_k):
    rng = np.random.default_rng(T + out_f + block_k)
    q, s = _q8(rng, 1, out_f, in_f)
    qp = np.ascontiguousarray(kp.permute_kaxis(q[0], block_k))
    x = rng.standard_normal((T, in_f)).astype(np.float32)
    xp = kp.permute_kaxis(_bf16(x), block_k)
    s_bf = jnp.asarray(s[0]).astype(jnp.bfloat16)
    st = torch.from_numpy(np.asarray(s_bf.astype(jnp.float32))).to(torch.bfloat16)
    xpt, qpt = torch.from_numpy(np.ascontiguousarray(xp)), torch.from_numpy(qp)
    got = kp.q8_matmul_perm_split_plain(xpt, qpt, st, block_k)
    assert got.dtype == torch.float32 and got.shape == (T, out_f)
    _within(got.numpy(), kp.q8_matmul_perm_plain(xpt, qpt, st, block_k).numpy())
    # the reference runs 8 rows or more: at one row XLA on the CPU keeps the interpret-mode
    # kernel's dequantised weights in f32 instead of rounding them to bf16 (rows are independent)
    rows = max(T, 8)
    xp_ref = np.concatenate([xp, np.zeros((rows - T, in_f), np.float32)])
    want = np.asarray(ref._q8_matmul_perm_2d(jnp.asarray(xp_ref), jnp.asarray(qp), s_bf, rows, out_f, block_k,
                                             interpret=True))[:T]
    _within(got.numpy(), want)
    # and the natural product on unpermuted operands
    natural = q8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q[0]), st)
    _within(got.numpy(), natural.numpy())


def test_perm_split_plain_dequantises_each_column_with_its_own_scale():
    """Integer activations and power-of-two scales: every product and partial
    sum is exact, so the permuted schedule equals the natural product bitwise."""
    rng = np.random.default_rng(9)
    block_k, T, out_f, in_f = 512, 3, 40, 1024
    q = torch.from_numpy(rng.integers(-127, 127, size=(out_f, in_f), dtype=np.int8))
    s = torch.from_numpy(2.0 ** rng.integers(-6, 0, size=(out_f, in_f // 32)).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.integers(-4, 4, size=(T, in_f)).astype(np.float32))
    got = kp.q8_matmul_perm_split_plain(kp.permute_kaxis(x, block_k), kp.permute_kaxis(q, block_k).contiguous(), s,
                                        block_k)
    assert torch.equal(got, q8_matmul_plain(x, q, s))


def _code(path):
    """The source with its comments taken out."""
    text = path.read_text()
    return re.sub(r"//[^\n]*", "", re.sub(r"/\*.*?\*/", "", text, flags=re.S))


def test_the_probes_are_instantiations_of_the_shipped_gemv():
    """``q8_probe.cu`` has no kernel of its own: its variants are the body in
    ``q8_gemv.cuh`` that ``lwt_q8_matmul`` runs at T <= 8, so a change to the
    GEMV carries the probes with it."""
    probe, matmul, gemv = _code(CSRC / "q8_probe.cu"), _code(CSRC / "q8_matmul.cu"), _code(CSRC / "q8_gemv.cuh")
    for text in (probe, matmul):
        assert '#include "q8_gemv.cuh"' in text
    assert "__global__" not in probe
    assert "__global__" in gemv and "q8_gemv_kernel" in gemv
    assert "launch_gemv<kFull>" in matmul
    for variant in ("kNoScale", "kLoad", "kPerm"):
        assert f"launch_probe<{variant}>" in probe
    # the body is defined once: no source names the kernel but the header
    assert [path.name for path in sorted(CSRC.glob("*.cu")) if "q8_gemv_kernel" in _code(path)] == []

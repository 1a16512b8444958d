"""The k-permuted Q8_0 layout ("kperm") on the H100: a probe, not serving code.

Counterpart of the reference's ``scripts/exp_q8_kperm_probe.py`` and its TPU
kernels ``_q8_matmul_perm_2d`` and ``_q8_matmul_stacked_perm_2d``; the CUDA
entry is ``lwt_q8_matmul_perm`` in ``csrc/q8_probe.cu``, an instantiation of
the shipped decode GEMV's body (``csrc/q8_gemv.cuh``) that differs from the
shipped product in its per-chunk term alone.

Within every ``block_k`` block of the k-axis, permuted column ``a*nb + b``
holds original column ``b*32 + a`` (``nb = block_k / 32``), so the scale of
permuted column ``j`` is ``s[o, j % nb]``. On the TPU that made the scale
expansion a free tiled repeat. The H100's GEMV multiplies one per-32 scale in
registers, so here the layout asks the opposite question: what it costs a
lane's 16-quant load to need 16 scales (at ``block_k`` a multiple of 512 they
are one 32-byte window of the row's scales, read from L1 after the row's
first lane). The product is exact: the same bf16 products as the natural
layout, summed in another order. Its schedule in torch is
:func:`q8_matmul_perm_split_plain`. At T <= 8 it runs the shipped GEMV's
schedule; above 8 rows the shipped product is the tile kernel, and the
comparison with it means nothing there.

    python -m light_whisper_tpu_torch.scripts.exp_q8_kperm_probe --selftest  # exactness
    python -m light_whisper_tpu_torch.scripts.exp_q8_kperm_probe --bench     # per-call chain A/B

Both run on the card unless ``--device cpu`` (the self-test only: the CPU
takes the plain versions).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from light_whisper_tpu_torch.ops import _build
from light_whisper_tpu_torch.ops.q8_matmul import (
    Q8_0_BLOCK,
    _aligned,
    _device_kind,
    _require,
    GEMV_SPLITS,
    q8_matmul_plain,
    q8_matmul_stacked,
    split_product,
)
from light_whisper_tpu_torch.scripts._probe import (
    HBM_BYTES_PER_S,
    card_line,
    device_ms_per_call,
    q8_weight_bytes,
    require_card,
)

SELFTEST_BLOCK_K = 512  # the reference's block_k at the self-test's 512 x 1024
BENCH_BLOCK_K = 2048  # the reference's block_k at its bench shape, 12288 x 2048

LAUNCHES = {"q8_matmul_perm": 0, "q8_matmul_stacked_perm": 0}


def _swap_last(a, n1: int, n2: int):
    """``a[..., n]`` viewed as ``[..., n / (n1·n2), n1, n2]``, the last two axes
    swapped, flattened back (numpy arrays and tensors alike)."""
    *lead, n = a.shape
    return a.reshape(*lead, n // (n1 * n2), n1, n2).swapaxes(-1, -2).reshape(*lead, n)


def permute_kaxis(a, block_k: int):
    """Within each ``block_k`` block of the last axis, position ``a*nb + b`` ←
    old position ``b*32 + a``."""
    return _swap_last(a, block_k // Q8_0_BLOCK, Q8_0_BLOCK)


def unpermute_kaxis(a, block_k: int):
    """Inverse of :func:`permute_kaxis`."""
    return _swap_last(a, Q8_0_BLOCK, block_k // Q8_0_BLOCK)


def expand_scales_perm(s, block_k: int):
    """Per-k scales of the permuted layout: within each block, position ``j``
    carries ``s[..., j % nb]`` of that block."""
    nb = block_k // Q8_0_BLOCK
    *lead, n_scales = s.shape
    k_blocks = n_scales // nb
    s3 = s.reshape(*lead, k_blocks, 1, nb)
    shape = (*lead, k_blocks, Q8_0_BLOCK, nb)
    s3 = s3.expand(*shape) if isinstance(s3, torch.Tensor) else np.broadcast_to(s3, shape)
    return s3.reshape(*lead, k_blocks * block_k)


# -- the matmul over the permuted layout -----------------------------------------


def q8_matmul_perm_plain(xp: torch.Tensor, qp: torch.Tensor, s: torch.Tensor, block_k: int) -> torch.Tensor:
    """Unpermute, then the natural product (``q8_matmul_plain``)."""
    return q8_matmul_plain(unpermute_kaxis(xp, block_k), unpermute_kaxis(qp, block_k), s)


def q8_matmul_perm_split_plain(xp: torch.Tensor, qp: torch.Tensor, s: torch.Tensor, block_k: int,
                               splits: int = GEMV_SPLITS) -> torch.Tensor:
    """The kernel's schedule in torch: the permuted weights dequantised with
    their own scales (``bf16(q·s)`` a column), each split of the permuted K
    axis summed in f32, the partials in rank order."""
    w = qp.to(torch.bfloat16) * expand_scales_perm(s.to(torch.bfloat16), block_k)
    return split_product(xp, w.float(), splits)


def _launch(form: str, xp: torch.Tensor, qp: torch.Tensor, s: torch.Tensor, block_k: int) -> torch.Tensor:
    T, K = xp.shape
    N = qp.shape[0]
    dev = xp.device
    _require(qp.dtype == torch.int8 and qp.shape == (N, K), f"qp must be int8 [{N}, {K}]")
    _require(s.dtype == torch.bfloat16 and s.shape == (N, K // Q8_0_BLOCK), f"s must be bf16 [{N}, {K // Q8_0_BLOCK}]")
    _require(block_k % Q8_0_BLOCK == 0 and K % block_k == 0, f"block_k {block_k} must divide {K} in Q8 blocks")
    for name, t in (("qp", qp), ("s", s)):
        _require(t.device == dev and t.is_contiguous(), f"{name} must be contiguous on {dev}")
    _require(_aligned(qp), "qp must be 16-byte aligned")
    xp = xp.to(torch.bfloat16).contiguous()
    if not _aligned(xp):
        xp = xp.clone()
    y = torch.empty((T, N), dtype=torch.float32, device=dev)
    err = _build.library().lwt_q8_matmul_perm(xp.data_ptr(), qp.data_ptr(), s.data_ptr(), y.data_ptr(), T, N, K,
                                              block_k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lwt_q8_matmul_perm")
    LAUNCHES[form] += 1
    return y


def q8_matmul_perm_2d(xp: torch.Tensor, qp: torch.Tensor, s: torch.Tensor, block_k: int) -> torch.Tensor:
    """``xp [T, in]`` (permuted) against ``qp [out, in]`` (permuted) → f32 ``[T, out]``."""
    if _device_kind(xp) == "cpu":
        return q8_matmul_perm_plain(xp, qp, s, block_k)
    return _launch("q8_matmul_perm", xp, qp, s, block_k)


def q8_matmul_stacked_perm_2d(xp: torch.Tensor, qp: torch.Tensor, s: torch.Tensor, layer: int,
                              block_k: int) -> torch.Tensor:
    """Layer ``layer`` of stacked ``qp [L, out, in]`` / ``s [L, out, in/32]``."""
    if _device_kind(xp) == "cpu":
        return q8_matmul_perm_plain(xp, qp[layer], s[layer], block_k)
    return _launch("q8_matmul_stacked_perm", xp, qp[layer], s[layer], block_k)


def q8_matmul_perm(x: torch.Tensor, qp: torch.Tensor, s: torch.Tensor, block_k: int) -> torch.Tensor:
    """Natural ``x``: permuted to ``qp``'s layout within the call, as the
    reference's dispatch wrapper does."""
    return q8_matmul_perm_2d(permute_kaxis(x.to(torch.bfloat16), block_k), qp, s, block_k)


# -- self-test and bench ---------------------------------------------------------


def selftest(device: str = "cuda") -> None:
    """The reference's checks: the permutation is a bijection, the permuted
    dequant is exact, and the kernel matches the natural product (1e-4 of
    max|y|: only the order of the f32 sums differs)."""
    dev = require_card(device)
    rng = np.random.default_rng(0)
    out_f, in_f, bk = 512, 1024, SELFTEST_BLOCK_K
    q = rng.integers(-127, 127, size=(out_f, in_f), dtype=np.int8)
    s = (rng.random((out_f, in_f // 32), dtype=np.float32) * 0.01 + 0.001).astype(np.float32)
    x = rng.standard_normal((16, in_f)).astype(np.float32)

    a = rng.standard_normal((3, in_f)).astype(np.float32)
    p = permute_kaxis(a, bk)
    assert sorted(p[0].tolist()) == sorted(a[0].tolist()), "permutation is not a bijection"
    np.testing.assert_array_equal(unpermute_kaxis(p, bk), a)

    qp = permute_kaxis(q, bk)
    deq_perm = qp.astype(np.float32) * expand_scales_perm(s, bk)
    deq_nat = q.astype(np.float32) * np.repeat(s, Q8_0_BLOCK, axis=-1)
    np.testing.assert_array_equal(unpermute_kaxis(deq_perm, bk), deq_nat)

    qt = torch.from_numpy(q).to(dev)
    qpt = torch.from_numpy(np.ascontiguousarray(qp)).to(dev)
    st = torch.from_numpy(s).to(torch.bfloat16).to(dev)
    xt = torch.from_numpy(x).to(dev)
    want = q8_matmul_plain(xt, qt, st)
    got = q8_matmul_perm(xt, qpt, st, bk)
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert err <= tol, f"perm kernel differs from the natural product by {err:.3g} (tol {tol:.3g})"
    print(f"selftest OK on {dev}: permutation bijective, dequant exact, kernel matches (max|d| {err:.3g})")


def bench(device: str = "cuda", steps: int = 16) -> None:
    """Per call, over an alternating chain of L = 4 layers at the reference's
    shape (gateup 12288 x 2048, T = 8): natural (the shipped stacked kernel),
    perm (activations permuted in the call) and perm_nox (the permuted kernel
    with no activation permute: wrong math, true cost)."""
    dev = require_card(device)
    if dev.type != "cuda":
        raise SystemExit("--bench times the card")
    out_f, in_f, L, T, bk = 12288, 2048, 4, 8, BENCH_BLOCK_K
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    q = torch.randint(-127, 127, (L, out_f, in_f), generator=gen, device=dev, dtype=torch.int8)
    s = (torch.rand((L, out_f, in_f // 32), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    qp = permute_kaxis(q, bk).contiguous()
    x = torch.randn((T, in_f), generator=gen, device=dev).to(torch.bfloat16)
    xp = permute_kaxis(x, bk).contiguous()
    modes = {
        "natural": lambda i: q8_matmul_stacked(x, q, s, i % L),
        "perm": lambda i: q8_matmul_stacked_perm_2d(permute_kaxis(x, bk), qp, s, i % L, bk),
        "perm_nox": lambda i: q8_matmul_stacked_perm_2d(xp, qp, s, i % L, bk),
    }
    card = card_line()
    for mode, fn in modes.items():
        ms = device_ms_per_call(fn, steps * L)
        gbps = q8_weight_bytes(out_f, in_f) / (ms * 1e-3) / 1e9
        print(f"{mode:8s}: {ms * 1000:8.2f} us/call ({steps}x{L} alternating chain, T={T}, "
              f"{out_f}x{in_f}, block_k={bk}): {gbps:7.1f} GB/s of {HBM_BYTES_PER_S / 1e9:.0f} [{card}]")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--selftest", action="store_true")
    parser.add_argument("--bench", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.selftest or not args.bench:
        selftest(args.device)
    if args.bench:
        bench(args.device)


if __name__ == "__main__":
    main()

"""Is the Q8_0 decode GEMV load-bound or dequant-bound on the H100? A probe.

Counterpart of the reference's ``scripts/exp_q8_compute_bound.py`` and its TPU
kernel ``_run_variant``. Every variant keeps the block schedule of the port's
shipped GEMV (``csrc/q8_matmul.cu``: a warp an output row, 16-byte loads, x
in shared memory); the new kernels are ``lwt_q8_probe`` and
``lwt_q8_matmul_perm`` in ``csrc/q8_probe.cu``:

- ``full``: the shipped kernel, ``lwt_q8_matmul`` (``q8_matmul_stacked``);
- ``noscale``: the int8 → bf16 cast and the dot, no scale;
- ``load``: reads every quant and scale byte and touches T×m outputs, with
  the loads kept alive: the load ceiling of this schedule;
- ``permexact``: the k-permuted layout's exact product (the kperm probe's
  kernel), the activation permute inside the call as in the reference.

The reference's ``subexpand`` and ``repeatcost`` measured its TPU kernel's
expand matmul, the one-hot product that built per-k scales. The CUDA kernel
has no expand product: it multiplies a per-32 scale in registers. So
``subexpand`` is ``full`` (bit-identical by construction) and ``repeatcost``
(the permuted scale pattern's cost) is what ``permexact`` measures exactly;
both names run those kernels here.

    python -m light_whisper_tpu_torch.scripts.exp_q8_compute_bound           # per variant and shape
    python -m light_whisper_tpu_torch.scripts.exp_q8_compute_bound --chain   # four-projection chain

Per shape (the reference's gateup 12288×2048 at T=8, L=28, and the 0.6B
decode projections at T=1 and 8): device µs a call over layer-cycled calls
(every call reads its weights from HBM), GB/s of weight bytes against
3.35 TB/s. ``--chain`` runs qkv, o, gateup, down layer after layer, which
gives the sustained rate across alternating weight streams. On the card only.
"""

from __future__ import annotations

import argparse

import torch

from light_whisper_tpu_torch.ops import _build
from light_whisper_tpu_torch.ops.q8_matmul import Q8_0_BLOCK, _aligned, _device_kind, _require, q8_matmul_stacked
from light_whisper_tpu_torch.scripts._probe import (
    HBM_BYTES_PER_S,
    card_line,
    device_ms_per_call,
    q8_weight_bytes,
    require_card,
)
from light_whisper_tpu_torch.scripts.exp_q8_kperm_probe import permute_kaxis, q8_matmul_stacked_perm_2d

L = 28
LOAD_BLOCK_K = 512  # load's touch block: a warp's 32 lanes x 16 bytes
PERM_BLOCK_K = 512
VARIANTS = ("load", "noscale", "full", "permexact", "subexpand", "repeatcost")
# the reference's expand-matmul variants, as the kernels that answer them here
SAME_KERNEL = {"subexpand": "full", "repeatcost": "permexact"}
SHAPES_06B = {"qkv": (4096, 1024), "o": (1024, 2048), "gateup": (6144, 1024), "down": (1024, 3072)}
SHAPES_17B = {"qkv": (4096, 2048), "o": (2048, 2048), "gateup": (12288, 2048), "down": (2048, 6144)}

LAUNCHES = {"q8_probe": 0}
_PROBE_VARIANT = {"noscale": 0, "load": 1}  # lwt_q8_probe's variant argument


# -- plain versions ---------------------------------------------------------------


def noscale_plain(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``bf16(x) · float(q)^T`` in f32: the cast and the dot, no scale."""
    return torch.matmul(x.to(torch.bfloat16).float(), q.float().t())


def load_plain(q: torch.Tensor, rows: int, block_k: int = LOAD_BLOCK_K) -> torch.Tensor:
    """``y[t, i] = Σ_kb q[t, kb·block_k + i]`` for ``i < min(out, block_k)``,
    else 0: the TPU body's ``acc[:, :m] += q[:T, :m]`` at one block of all
    ``out`` rows. f32 ``[rows, out]``."""
    N, K = q.shape
    m = min(N, block_k)
    y = torch.zeros((rows, N), dtype=torch.float32, device=q.device)
    y[:, :m] = q[:rows].float().reshape(rows, K // block_k, block_k)[:, :, :m].sum(dim=1)
    return y


# -- the probe kernel --------------------------------------------------------------


def q8_probe(variant: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
             block_k: int = LOAD_BLOCK_K) -> torch.Tensor:
    """``noscale`` or ``load`` over one layer's ``q [out, in]`` / ``s [out, in/32]``
    and ``x [T, in]`` → f32 ``[T, out]``."""
    T, K = x.shape
    N = q.shape[0]
    _require(variant in _PROBE_VARIANT, f"unknown probe variant {variant!r}")
    if _device_kind(x) == "cpu":
        return noscale_plain(x, q) if variant == "noscale" else load_plain(q, T, block_k)
    dev = x.device
    _require(q.dtype == torch.int8 and q.shape == (N, K) and q.is_contiguous() and _aligned(q),
             f"q must be contiguous aligned int8 [{N}, {K}]")
    _require(s.dtype == torch.bfloat16 and s.shape == (N, K // Q8_0_BLOCK) and s.is_contiguous(),
             f"s must be contiguous bf16 [{N}, {K // Q8_0_BLOCK}]")
    _require(q.device == dev and s.device == dev, f"weights not on {dev}")
    _require(block_k % Q8_0_BLOCK == 0 and K % block_k == 0 and T <= N, "block_k must divide in; T <= out")
    x = x.to(torch.bfloat16).contiguous()
    if not _aligned(x):
        x = x.clone()
    y = torch.empty((T, N), dtype=torch.float32, device=dev)
    err = _build.library().lwt_q8_probe(_PROBE_VARIANT[variant], x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                        y.data_ptr(), T, N, K, block_k, 0.0,
                                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lwt_q8_probe")
    LAUNCHES["q8_probe"] += 1
    return y


def run_variant(variant: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, layer: int) -> torch.Tensor:
    """One call of ``variant`` on layer ``layer`` of stacked weights. For
    ``permexact`` (and ``repeatcost``) ``q`` is in the permuted layout and the
    activation permute is part of the call."""
    variant = SAME_KERNEL.get(variant, variant)
    if variant == "full":
        return q8_matmul_stacked(x, q, s, layer)
    if variant == "permexact":
        return q8_matmul_stacked_perm_2d(permute_kaxis(x.to(torch.bfloat16), PERM_BLOCK_K), q, s, layer,
                                         PERM_BLOCK_K)
    return q8_probe(variant, x, q[layer], s[layer])


# -- measurements ----------------------------------------------------------------------


def _stack(dev, gen, layers: int, out_f: int, in_f: int, permuted: bool):
    q = torch.randint(-127, 127, (layers, out_f, in_f), generator=gen, device=dev, dtype=torch.int8)
    s = (torch.randn((layers, out_f, in_f // Q8_0_BLOCK), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    return (permute_kaxis(q, PERM_BLOCK_K).contiguous() if permuted else q), s


def check_permexact(dev, gen, out_f: int, in_f: int, rows: int) -> float:
    """permexact on permuted weights against full on the natural ones; the
    largest difference relative to max|y|."""
    q, s = _stack(dev, gen, 2, out_f, in_f, permuted=False)
    qp = permute_kaxis(q, PERM_BLOCK_K).contiguous()
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    want = run_variant("full", x, q, s, 1)
    got = run_variant("permexact", x, qp, s, 1)
    return float((got - want).abs().max()) / max(1e-30, float(want.abs().max()))


def bench_variant(dev, gen, variant: str, out_f: int, in_f: int, rows: int, layers: int = L):
    """Device ms a call and GB/s of weight bytes, over ``layers``-cycled calls."""
    permuted = SAME_KERNEL.get(variant, variant) == "permexact"
    q, s = _stack(dev, gen, layers, out_f, in_f, permuted)
    x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
    ms = device_ms_per_call(lambda i: run_variant(variant, x, q, s, i % layers), layers)
    del q, s
    return ms, q8_weight_bytes(out_f, in_f) / (ms * 1e-3) / 1e9


def bench_chain(dev, gen, variant: str, shapes, rows: int, steps: int = 4):
    """qkv, o, gateup, down of every layer in turn, ``steps`` decode steps:
    device ms a step and the sustained GB/s of weight bytes."""
    permuted = SAME_KERNEL.get(variant, variant) == "permexact"
    bufs = [(*_stack(dev, gen, L, out_f, in_f, permuted),
             torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16))
            for out_f, in_f in shapes.values()]

    def step(_):
        for layer in range(L):
            for q, s, x in bufs:
                run_variant(variant, x, q, s, layer)

    ms = device_ms_per_call(step, steps)
    step_bytes = L * sum(q8_weight_bytes(*shape) for shape in shapes.values())
    del bufs
    return ms, step_bytes / (ms * 1e-3) / 1e9


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chain", action="store_true", help="the four-projection chain per variant")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = require_card(args.device)
    if dev.type != "cuda":
        raise SystemExit("the probe times the card")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    card = card_line()
    peak = HBM_BYTES_PER_S / 1e9
    print(f"[q8probe] {torch.cuda.get_device_name(dev)} [{card}], L={L}; GB/s of weight bytes against {peak:.0f}")
    if args.chain:
        for label, shapes, rows in (("0.6B", SHAPES_06B, 1), ("0.6B", SHAPES_06B, 8), ("1.7B", SHAPES_17B, 8)):
            for variant in ("load", "noscale", "full", "permexact"):
                ms, gbps = bench_chain(dev, gen, variant, shapes, rows)
                print(f"[q8probe] chain {label} T={rows} {variant:9s}: {ms:8.4f} ms/step -> {gbps:7.1f} GB/s "
                      f"({100 * gbps / peak:5.1f}% of {peak:.0f})")
        return
    cases = [("gateup 1.7B", 12288, 2048, 8)]
    for rows in (1, 8):
        cases += [(name, *SHAPES_06B[name], rows) for name in ("qkv", "gateup", "down")]
    for name, out_f, in_f, rows in cases:
        rel = check_permexact(dev, gen, out_f, in_f, rows)
        print(f"[q8probe] {name} {out_f}x{in_f} T={rows}: permexact vs full max|d|/max|y| = {rel:.3g}")
        if rel > 1e-4:
            raise SystemExit(f"permexact differs from full by {rel:.3g} of max|y| (tol 1e-4)")
        for variant in VARIANTS:
            ms, gbps = bench_variant(dev, gen, variant, out_f, in_f, rows)
            same = f" (= {SAME_KERNEL[variant]})" if variant in SAME_KERNEL else ""
            print(f"[q8probe] {name} {out_f}x{in_f} T={rows} {variant:10s}{same:14s}: {ms * 1000:8.2f} us/call -> "
                  f"{gbps:7.1f} GB/s ({100 * gbps / peak:5.1f}% of {peak:.0f})")


if __name__ == "__main__":
    main()

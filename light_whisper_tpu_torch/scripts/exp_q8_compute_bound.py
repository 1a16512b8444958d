"""Is the Q8_0 decode GEMV load-bound or dequant-bound on the H100? A probe.

Counterpart of the reference's ``scripts/exp_q8_compute_bound.py`` and its TPU
kernel ``_run_variant``. Every variant runs the body of the port's shipped
decode GEMV (``csrc/q8_gemv.cuh``, ``q8_gemv_kernel``: 4 warps a CTA, 8 weight
rows a group on ``mma.sync``, K split over the 4 warps at every T, x staged by
``cp.async``, two register batches of quants in flight, the warps' partials
summed in warp order); only the per-chunk term differs, so at T <= 8 each
difference isolates one cost:

- ``full``: the shipped kernel, ``lwt_q8_matmul`` (``q8_matmul_stacked``);
- ``noscale``: the quants converted to bf16 with no scale multiply (the
  scales still loaded), then the same mma: ``full − noscale`` is the scale
  multiply;
- ``load``: full's loads of x, quants and scales, no dequant and no mma,
  touching T×m outputs: the load ceiling of the schedule that ships;
- ``permexact``: the k-permuted layout's exact product (the kperm probe's
  kernel), 16 scales a lane: ``permexact − full`` is what they cost. Timed
  on x permuted ahead (the kernel alone); :func:`run_variant` permutes x in
  the call, as the reference does.

``noscale`` and ``load`` are ``lwt_q8_probe``, ``permexact``
``lwt_q8_matmul_perm`` (``csrc/q8_probe.cu``). Above 8 rows the shipped
product is the tile kernel, so the variants' differences mean nothing there.

The reference's ``subexpand`` and ``repeatcost`` measured its TPU kernel's
expand matmul, the one-hot product that built per-k scales. The CUDA kernel
has no expand product: it multiplies a per-32 scale in registers. So
``subexpand`` is ``full`` (bit-identical by construction) and ``repeatcost``
(the permuted scale pattern's cost) is what ``permexact`` measures exactly;
both names run those kernels here.

    python -m light_whisper_tpu_torch.scripts.exp_q8_compute_bound           # per variant and shape
    python -m light_whisper_tpu_torch.scripts.exp_q8_compute_bound --chain   # four-projection chain

Per shape (the reference's gateup 12288×2048 at T=8, L=28, and the 0.6B
decode projections at T=1 and 8): device ms a call over layer-cycled calls
(every call reads its weights from HBM), GB/s of weight bytes against
3.35 TB/s, the bound (the case's bytes over 3.35 TB/s), the derived terms
``load − bound``, ``noscale − load``, ``full − noscale`` and ``permexact −
full``, and a bf16 reading: ``torch.matmul`` of x against the layer's weight
dequantised to bf16 ahead of time and held resident (twice the weight bytes;
a reading of the library's GEMV, not a call that computes the probe's
function and not a port). ``--chain`` runs qkv, o, gateup, down layer after
layer, which gives the sustained rate across alternating weight streams. On
the card only.
"""

from __future__ import annotations

import argparse

import torch

from light_whisper_tpu_torch.ops import _build
from light_whisper_tpu_torch.ops.q8_matmul import (
    GEMV_SPLITS,
    Q8_0_BLOCK,
    _aligned,
    _device_kind,
    _require,
    dequantize,
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
from light_whisper_tpu_torch.scripts.exp_q8_kperm_probe import permute_kaxis, q8_matmul_stacked_perm_2d

L = 28
LOAD_BLOCK_K = 512  # load's touch block (the reference's block_k at its qkv, o and down shapes)
PERM_BLOCK_K = 512
VARIANTS = ("load", "noscale", "full", "permexact", "subexpand", "repeatcost")
TIMED = ("load", "noscale", "full", "permexact")  # the four kernels; the other two names run two of them
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


def noscale_split_plain(x: torch.Tensor, q: torch.Tensor, splits: int = GEMV_SPLITS) -> torch.Tensor:
    """:func:`noscale_plain` as the GEMV sums it: each K split in f32, the
    partials in rank order."""
    return split_product(x, q.float(), splits)


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


class Operands:
    """One projection's weights over ``layers`` layers in every form a timed
    call reads: natural and k-permuted Q8_0, and bf16 dequantised ahead of
    time; x natural and permuted."""

    def __init__(self, dev, gen, layers: int, out_f: int, in_f: int, rows: int):
        self.q = torch.randint(-127, 127, (layers, out_f, in_f), generator=gen, device=dev, dtype=torch.int8)
        self.s = (torch.randn((layers, out_f, in_f // Q8_0_BLOCK), generator=gen, device=dev) * 0.01).to(
            torch.bfloat16)
        self.qp = permute_kaxis(self.q, PERM_BLOCK_K).contiguous()
        self.w = dequantize(self.q, self.s)
        self.x = torch.randn((rows, in_f), generator=gen, device=dev).to(torch.bfloat16)
        self.xp = permute_kaxis(self.x, PERM_BLOCK_K).contiguous()

    def call(self, variant: str, layer: int) -> torch.Tensor:
        """One timed call: the operands prepared ahead (permexact's x permuted
        outside the call; ``bf16`` the reading against the resident bf16 weight)."""
        variant = SAME_KERNEL.get(variant, variant)
        if variant == "permexact":
            return q8_matmul_stacked_perm_2d(self.xp, self.qp, self.s, layer, PERM_BLOCK_K)
        if variant == "bf16":
            return torch.matmul(self.x, self.w[layer].t())
        return run_variant(variant, self.x, self.q, self.s, layer)


def check_permexact(ops: Operands, layer: int = 1) -> float:
    """permexact on permuted weights against full on the natural ones; the
    largest difference relative to max|y|."""
    want = run_variant("full", ops.x, ops.q, ops.s, layer)
    got = run_variant("permexact", ops.x, ops.qp, ops.s, layer)
    return float((got - want).abs().max()) / max(1e-30, float(want.abs().max()))


def case_bytes(out_f: int, in_f: int, rows: int) -> int:
    """What a call must move: x, the quants and scales, the f32 output."""
    return rows * in_f * 2 + q8_weight_bytes(out_f, in_f) + rows * out_f * 4


def terms(ms: dict, bound: float) -> dict:
    """The differences that isolate one cost each (ms)."""
    return {"load-bound": ms["load"] - bound, "noscale-load": ms["noscale"] - ms["load"],
            "full-noscale": ms["full"] - ms["noscale"], "permexact-full": ms["permexact"] - ms["full"]}


def bench_case(dev, gen, out_f: int, in_f: int, rows: int, layers: int = L) -> dict:
    """Device ms a call of every timed variant and of the bf16 reading, over
    ``layers``-cycled calls on one set of operands."""
    ops = Operands(dev, gen, layers, out_f, in_f, rows)
    rel = check_permexact(ops)
    if rel > 1e-4:
        raise SystemExit(f"permexact differs from full by {rel:.3g} of max|y| (tol 1e-4)")
    ms = {v: device_ms_per_call(lambda i, v=v: ops.call(v, i % layers), layers) for v in (*TIMED, "bf16")}
    return {"ms": ms, "permexact_rel": rel}


def bench_chain(dev, gen, shapes, rows: int, steps: int = 4) -> dict:
    """qkv, o, gateup, down of every layer in turn, ``steps`` decode steps,
    for every timed variant and the bf16 reading: device ms a step."""
    bufs = [Operands(dev, gen, L, out_f, in_f, rows) for out_f, in_f in shapes.values()]

    def step(variant):
        def run(_):
            for layer in range(L):
                for ops in bufs:
                    ops.call(variant, layer)
        return run

    ms = {v: device_ms_per_call(step(v), steps) for v in (*TIMED, "bf16")}
    del bufs
    return ms


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
    print(f"[q8probe] {torch.cuda.get_device_name(dev)} [{card}], L={L}; GB/s of Q8_0 weight bytes against {peak:.0f}"
          f" (bf16: of its own bf16 weight bytes)")
    if args.chain:
        for label, shapes, rows in (("0.6B", SHAPES_06B, 1), ("0.6B", SHAPES_06B, 8), ("1.7B", SHAPES_17B, 8)):
            ms = bench_chain(dev, gen, shapes, rows)
            q8_bytes = L * sum(q8_weight_bytes(*shape) for shape in shapes.values())
            bf16_bytes = L * sum(2 * out_f * in_f for out_f, in_f in shapes.values())
            floor = q8_bytes / HBM_BYTES_PER_S * 1e3
            for variant, t in ms.items():
                gbps = (bf16_bytes if variant == "bf16" else q8_bytes) / (t * 1e-3) / 1e9
                print(f"[q8probe] chain {label} T={rows} {variant:9s}: {t:8.4f} ms/step -> {gbps:7.1f} GB/s "
                      f"({100 * gbps / peak:5.1f}% of {peak:.0f}); weight floor {floor:.4f} ms/step")
        return
    cases = [("gateup 1.7B", *SHAPES_17B["gateup"], 8)]
    for rows in (1, 8):
        cases += [(name, *SHAPES_06B[name], rows) for name in ("qkv", "gateup", "down")]
    for name, out_f, in_f, rows in cases:
        got = bench_case(dev, gen, out_f, in_f, rows)
        ms = got["ms"]
        bound = case_bytes(out_f, in_f, rows) / HBM_BYTES_PER_S * 1e3
        head = f"[q8probe] {name} {out_f}x{in_f} T={rows}"
        print(f"{head}: permexact vs full max|d|/max|y| = {got['permexact_rel']:.3g}")
        for variant in (*TIMED, "bf16"):
            gbps = q8_weight_bytes(out_f, in_f) * (2 if variant == "bf16" else 1) / (ms[variant] * 1e-3) / 1e9
            print(f"{head} {variant:9s}: {ms[variant]:.4f} ms/call -> {gbps:7.1f} GB/s ({100 * gbps / peak:5.1f}% of "
                  f"{peak:.0f})")
        for alias, same in SAME_KERNEL.items():
            print(f"{head} {alias:9s}: = {same}")
        ordered = ms["load"] <= ms["noscale"] <= ms["full"] <= ms["permexact"]
        print(f"{head} bound {bound:.4f} ms (bytes); terms (ms) "
              + " ".join(f"{k}={v:.4f}" for k, v in terms(ms, bound).items())
              + f"; load<=noscale<=full<=permexact: {ordered}")


if __name__ == "__main__":
    main()

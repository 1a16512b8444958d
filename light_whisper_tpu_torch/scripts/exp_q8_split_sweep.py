"""The Q8_0 tile kernel (T > 8) at forced K splits and tile widths: the sweep
behind ``ops/q8_matmul.tile_splits`` and ``TILE_N``. A probe, not serving
code.

For each Qwen3-ASR 0.6B shape (N, K) it times ``lwt_q8_matmul_tile`` at
S = 1, 2, 4 and 8 (clusters of S CTAs) and tile widths 64, 128 and 256 for a few
row counts of the main path and prints the time of each, the bound and what
the shipped kernel takes (``TILE_N`` wide, ``tile_splits`` splits).
Weights are cycled over enough copies that each call reads them from HBM.

    python -m light_whisper_tpu_torch.scripts.exp_q8_split_sweep [--rows 64,156,3968]

Runs on the card only.
"""

from __future__ import annotations

import argparse

import torch

from light_whisper_tpu_torch.ops import _build
from light_whisper_tpu_torch.ops import q8_matmul as q8
from light_whisper_tpu_torch.scripts._probe import HBM_BYTES_PER_S, card_line, device_ms_per_call, q8_weight_bytes

BF16_FLOPS_PER_S = 989e12
L2_BYTES = 50 * 2**20
SHAPES = (("qkv", 4096, 1024), ("o", 1024, 2048), ("gateup", 6144, 1024), ("down", 1024, 3072),
          ("enc.fc1", 3584, 896), ("enc.fc2", 896, 3584), ("enc.conv_out", 896, 7680), ("enc.attn", 896, 896))


def tile_at(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, splits: int, width: int) -> torch.Tensor:
    """The tile kernel at ``splits`` and ``width`` (its wrapper takes
    ``tile_splits`` and ``TILE_N``)."""
    T, K = x.shape
    N = q.shape[0]
    y = torch.empty((T, N), dtype=torch.float32, device=x.device)
    _build.check(_build.library().lwt_q8_matmul_tile(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), T, N,
                                                     K, splits, width, torch.cuda.current_stream().cuda_stream),
                 "lwt_q8_matmul_tile")
    return y


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", default="64,156,3968", help="comma-separated row counts (each > 8)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the sweep runs on the card")
    rows = [int(r) for r in args.rows.split(",")]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    print(card_line(), flush=True)
    for name, N, K in SHAPES:
        copies = max(2, -(-2 * L2_BYTES // q8_weight_bytes(N, K)))
        q = torch.randint(-127, 128, (copies, N, K), generator=gen, device="cuda", dtype=torch.int8)
        s = (torch.rand((copies, N, K // 32), generator=gen, device="cuda") * 1e-4 + 1e-4).to(torch.bfloat16)
        for T in rows:
            x = torch.randn(T, K, generator=gen, device="cuda").to(torch.bfloat16)
            want = q8.q8_matmul_plain(x, q[0], s[0])
            times = {}
            for width in (64, 128, 256):
                for splits in (1, 2, 4, 8):
                    err = float((tile_at(x, q[0], s[0], splits, width) - want).abs().max())
                    if err > 1e-4 * max(1.0, float(want.abs().max())):
                        raise SystemExit(f"{name} T={T} S={splits} width {width}: max|d| {err:.3g} from the plain "
                                         "version")
                    times[width, splits] = device_ms_per_call(
                        lambda i: tile_at(x, q[i % copies], s[i % copies], splits, width), calls=copies)
            nbytes = T * K * 2 + q8_weight_bytes(N, K) + T * N * 4
            bound = max(nbytes / HBM_BYTES_PER_S, 2 * T * N * K / BF16_FLOPS_PER_S) * 1e3
            best = min(times, key=times.get)
            print(f"{name} {N}x{K} T={T}: " + " ".join(f"w{w}/S={k} {v:.4f}" for (w, k), v in times.items())
                  + f" ms; best w{best[0]}/S={best[1]}, picked w{q8.TILE_N}/S={q8.tile_splits(N, K)}; "
                  f"bound {bound:.4f} ms", flush=True)
        del q, s
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

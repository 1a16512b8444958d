"""A fingerprint of the shipped Q8_0 decode GEMV, to hold two checkouts against each other.

Runs ``q8_matmul_stacked_fused`` (C entry ``lwt_q8_matmul``, the GEMV at
T <= 8) on seeded inputs at the 0.6B decode shapes (qkv, o, gateup, down),
T = 1 and 8, with and without the rms-norm prologue and the residual
epilogue, and prints a SHA-256 of each output's bytes and of all of them;
then ``q8_gemv_kernel``'s lines of the ptxas report (registers, spills,
shared memory) and the device times of the five stacked-fused decode cases
that ``chip_smoke.py`` times (28 layers cycled).

    python light_whisper_tpu_torch/scripts/exp_q8_gemv_digest.py [--tree DIR]

``--tree`` imports ``light_whisper_tpu_torch`` from another checkout (its
sources, its build), so that a parent commit unpacked beside this one is
fingerprinted by the same code: run parent, change, change, parent in one
session on one card, and compare. Run it by path, not with ``-m``. On the
card only.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import re
import sys

L = 28
SHAPES = {"qkv": (4096, 1024), "o": (1024, 2048), "gateup": (6144, 1024), "down": (1024, 3072)}
TIMED = ((1, "qkv", True, False), (1, "o", False, True), (1, "down", True, True), (8, "qkv", True, False),
         (8, "down", False, True))
EPS = 1e-6


def gemv_report(log: str) -> list:
    """The ptxas lines of every ``q8_gemv_kernel`` entry in a ``-Xptxas -v`` log."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "q8_gemv_kernel" in line
        if keep and ("Compiling entry" in line or "registers" in line or "stack frame" in line):
            lines.append(line.strip())
    return lines


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                        help="the checkout whose light_whisper_tpu_torch is fingerprinted")
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    from light_whisper_tpu_torch.ops import _build
    from light_whisper_tpu_torch.ops import q8_matmul as q8
    from light_whisper_tpu_torch.scripts._probe import card_line, device_ms_per_call, require_card

    if not os.path.abspath(q8.__file__).startswith(tree + os.sep):
        raise SystemExit(f"light_whisper_tpu_torch came from {q8.__file__}, not from {tree}")
    dev = require_card("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[digest] tree {tree}: {torch.cuda.get_device_name(dev)} [{card_line()}]")
    _build.library()
    report = gemv_report(_build.build_log)
    for line in report or ["(library built earlier: no ptxas report in this process)"]:
        print(f"[digest] ptxas {line}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stacks = {}
    for name, (N, K) in SHAPES.items():
        q = torch.randint(-127, 128, (L, N, K), generator=gen, device=dev, dtype=torch.int8)
        s = (torch.rand((L, N, K // 32), generator=gen, device=dev) * 0.02 / 127 + 1e-4).to(torch.bfloat16)
        stacks[name] = q, s
    total = hashlib.sha256()
    for name, (N, K) in SHAPES.items():
        q, s = stacks[name]
        for T in (1, 8):
            x = torch.randn((T, K), generator=gen, device=dev).to(torch.bfloat16)
            norm_w = 1.0 + 0.1 * torch.randn(K, generator=gen, device=dev)
            res = torch.randn((T, N), generator=gen, device=dev).to(torch.bfloat16)
            for with_norm in (False, True):
                for with_res in (False, True):
                    y = q8.q8_matmul_stacked_fused(x, q, s, 5, norm_w=norm_w if with_norm else None, eps=EPS,
                                                   residual=res if with_res else None)
                    raw = y.cpu().numpy().tobytes()
                    total.update(raw)
                    label = f"{name} T={T}{' +norm' if with_norm else ''}{' +residual' if with_res else ''}"
                    print(f"[digest] sha256 {label}: {hashlib.sha256(raw).hexdigest()}")
    print(f"[digest] sha256 all: {total.hexdigest()}")

    for T, name, with_norm, with_res in TIMED:
        N, K = SHAPES[name]
        q, s = stacks[name]
        x = torch.randn((T, K), generator=gen, device=dev).to(torch.bfloat16)
        norm_w = 1.0 + 0.1 * torch.randn(K, generator=gen, device=dev) if with_norm else None
        res = torch.randn((T, N), generator=gen, device=dev).to(torch.bfloat16) if with_res else None
        ms = device_ms_per_call(
            lambda i: q8.q8_matmul_stacked_fused(x, q, s, i % L, norm_w=norm_w, eps=EPS, residual=res), L)
        label = f"{name}{' +norm' if with_norm else ''}{' +residual' if with_res else ''} T={T} {N}x{K}"
        print(f"[digest] time {label}: {ms:.4f} ms")
    match = re.search(r"Used (\d+) registers", " ".join(report))
    print(f"[digest] done ({'registers ' + match.group(1) if match else 'no ptxas report'})")


if __name__ == "__main__":
    main()

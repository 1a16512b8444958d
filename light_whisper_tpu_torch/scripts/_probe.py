"""What the probe entry points share: the card's identity, device timing and
the Q8_0 byte count.

Every time here is device time from CUDA events; a probe that finds no card
refuses to time anything.
"""

from __future__ import annotations

import subprocess
import time

import torch

from light_whisper_tpu_torch.ops.q8_matmul import Q8_0_BLOCK

# Published peak of one H100 SXM (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12


def require_card(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the timed probes run on the card (pass --device cpu for the checks alone)")
    return dev


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, as printed beside every number."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def q8_weight_bytes(out_features: int, in_features: int) -> int:
    """int8 quants and bf16 scales of one ``[out, in]`` Q8_0 matrix."""
    return out_features * in_features + out_features * (in_features // Q8_0_BLOCK) * 2


def device_ms_per_call(fn, calls: int, batches: int = 5) -> float:
    """Median over ``batches`` of the mean device time of ``calls`` back-to-back
    ``fn(i)``. A sleep kernel queued first, longer than the host takes to
    enqueue the calls, keeps host dispatch out of the event window."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(min(host_s * 4e9 + 2e6, 2**40))  # twice the enqueue at a 2 GHz clock
    means = []
    for _ in range(batches):
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / calls)
    means.sort()
    return means[len(means) // 2]

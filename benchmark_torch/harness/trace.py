"""A bounded ``torch.profiler`` slice of a run, reduced to what the per-layer
metrics and the ledger's breakdown read.

Device events are the kernels, copies and sets the card ran; the device is
busy where their union covers the slice. An idle gap is named by the
innermost host event (an ATen operator or a CUDA runtime call) that spans
its middle, or ``python`` where none does.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

LABELLED_GAPS = 200  # the longest gaps get a host label each
PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")  # the profiler's own bookkeeping, not the program
NAME_CHARS = 160  # kernel names are C++ templates; the head names them


@dataclasses.dataclass
class Slice:
    window_s: float
    busy_s: float
    kernel_time_s: Dict[str, float]  # device seconds by kernel name
    kernel_count: Dict[str, int]
    idle_by_host: Dict[str, float]  # seconds of the longest gaps, by host event
    launches: Dict[str, int]  # the program's launch counters over the slice
    requests: list  # the requests sent and answered inside the slice

    def time_of(self, fragment: str) -> float:
        return sum(t for name, t in self.kernel_time_s.items() if fragment in name)

    def count_of(self, fragment: str) -> int:
        return sum(n for name, n in self.kernel_count.items() if fragment in name)

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernel_time_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": [[n, t] for n, t in gaps]}


class Profiler:
    """``start()`` / ``stop()`` around a slice; ``stop`` returns the events."""

    def __init__(self, torch):
        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self._prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        device, host = [], []
        cuda = self.torch.autograd.DeviceType.CUDA
        for e in events:
            if e.name() in PROFILER_OWN:
                continue
            row = (e.name()[:NAME_CHARS], int(e.start_ns()), int(e.duration_ns()))
            (device if e.device_type() == cuda else host).append(row)
        return device, host


def reduce(device: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]], window_s: float,
           launches: Dict[str, int], requests: list) -> Slice:
    """The slice's busy time, per-kernel sums and labelled idle gaps."""
    kernel_time: Dict[str, float] = defaultdict(float)
    kernel_count: Dict[str, int] = defaultdict(int)
    for name, _start, dur in device:
        kernel_time[name] += dur * 1e-9
        kernel_count[name] += 1
    busy = 0.0
    idle: Dict[str, float] = defaultdict(float)
    if device:
        iv = np.array(sorted((s, s + d) for _n, s, d in device), dtype=np.int64)
        merged = []
        lo, hi = iv[0]
        for s, e in iv[1:]:
            if s > hi:
                merged.append((lo, hi))
                lo, hi = s, e
            else:
                hi = max(hi, e)
        merged.append((lo, hi))
        busy = sum(e - s for s, e in merged) * 1e-9
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:LABELLED_GAPS]
        if host:
            hs = np.array([s for _n, s, _d in host], dtype=np.int64)
            he = hs + np.array([d for _n, _s, d in host], dtype=np.int64)
        for length, g0, g1 in gaps:
            label = "python"
            if host:
                mid = (g0 + g1) // 2
                cover = np.nonzero((hs <= mid) & (he >= mid))[0]
                if cover.size:
                    label = host[int(cover[np.argmin(he[cover] - hs[cover])])][0]
            idle[label] += length * 1e-9
    return Slice(window_s, busy, dict(kernel_time), dict(kernel_count), dict(idle), launches, requests)

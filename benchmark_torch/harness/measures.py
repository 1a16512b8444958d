"""What a run recorded, and the arithmetic the metric readers share.

A reader (``metrics/<name>.py``) takes a :class:`Record` and returns a number,
or ``None`` where the run holds nothing for it to read; where a count that a
roofline rests on disagrees with the program's own, or the record's
architecture module has no such count, it says why on standard error and
returns ``None``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import statistics
import sys
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np

from harness import work
from harness.artifact import Shapes

RATE = 16_000


@dataclasses.dataclass
class Record:
    cell: str
    shapes: Shapes  # the architecture's (``arch.shapes`` of the configuration)
    arch: ModuleType  # archs/<arch>.py: the counts that the readers take
    budget: int  # tokens every request decodes (random weights never emit EOS)
    seconds: float  # the measured window
    setup_s: float
    requests: list  # every request sent in the window (client.Request)
    t_open: float
    stats_before: Dict
    stats_after: Dict
    slice: object = None  # trace.Slice of a traced run
    slice_span: tuple = (0.0, 0.0)  # (start, end) of the traced slice, host clock

    @property
    def t_close(self) -> float:
        return self.t_open + self.seconds

    def in_window(self) -> list:
        """Requests answered by the window's close (the ones a rate or a tail counts)."""
        return [r for r in self.requests if r.t_reply <= self.t_close]

    def served(self) -> list:
        """Successful requests answered in the window and outside the traced slice."""
        lo, hi = self.slice_span
        return [r for r in self.in_window() if ok(r) and not (lo <= r.t_sent and r.t_reply <= hi)]

    def effective_seconds(self) -> float:
        lo, hi = self.slice_span
        return self.seconds - (hi - lo)


def note(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def counts(record: Record, metric: str, *names: str) -> Optional[List[Callable]]:
    """The architecture's count functions ``names``, or ``None`` (with the
    reason) where its module has one of them not."""
    missing = [n for n in names if not callable(getattr(record.arch, n, None))]
    if missing:
        note(f"no {metric}: archs/{os.path.basename(record.arch.__file__)} has no {', '.join(missing)}")
        return None
    return [getattr(record.arch, n) for n in names]


def ok(req) -> bool:
    return bool(req.reply and req.reply.get("success") and req.reply.get("vad_segments", 0) > 0)


def latency_ms(req) -> float:
    return (req.t_reply - req.t_sent) * 1000.0


def speech_samples(req) -> int:
    """The trimmed audio the model saw: whole 10 ms hops, so the reply's
    millisecond ``speech_duration`` is exact."""
    return int(round(float(req.reply["speech_duration"]) * RATE))


def percentile_ms(record: Record, q: float) -> Optional[float]:
    """The ``q``-th percentile (linear between ranks, numpy's default) of
    every request answered in the window, a failed one counting as never
    answered: ``None`` where the percentile reaches one."""
    done = record.in_window()
    if not done:
        return None
    values = sorted(latency_ms(r) if ok(r) else math.inf for r in done)
    pos = q / 100.0 * (len(values) - 1)
    lo, hi = values[math.floor(pos)], values[math.ceil(pos)]
    if not math.isfinite(hi):
        return None
    return lo + (hi - lo) * (pos - math.floor(pos))


def median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


def wire_ms(record: Record) -> Optional[float]:
    """Client wall less the server's own VAD and inference walls."""
    return median(latency_ms(r) - r.reply["inference_ms"] - r.reply["vad_ms"] for r in record.served())


def step_lists(record: Record) -> List[list]:
    """Each decode-step list the paths filled, once (a batched tick shares one)."""
    seen, out = set(), []
    for r in record.served():
        if r.steps is not None and id(r.steps) not in seen:
            seen.add(id(r.steps))
            out.append(r.steps)
    return out


def mfu_percent(record: Record) -> Optional[float]:
    served = record.served()
    fns = counts(record, "mfu", "request_flops") if served else None
    if fns is None:
        return None
    request_flops, = fns
    flops = sum(request_flops(record.shapes, speech_samples(r), record.budget) for r in served)
    return 100.0 * flops / (record.effective_seconds() * work.BF16_FLOPS_PER_S)


# -- the traced slice -----------------------------------------------------------


def slice_groups(record: Record) -> Optional[Dict[str, int]]:
    """Decode forwards and prefill passes in the traced slice, from the
    program's launch counters, or ``None`` (with the reason) where those
    counters, the trace and the slice's requests disagree."""
    sl = record.slice
    if sl is None or not sl.requests:
        return None
    fns = counts(record, "roofline", "stacked_launches", "q8_matmul_launches", "gemv_launches",
                 "decode_attention_launches")
    if fns is None:
        return None
    stacked_launches, q8_matmul_launches, gemv_launches, decode_attention_launches = fns
    s, d = record.shapes, sl.launches
    per = stacked_launches(s)
    forwards, prefills = d.get("q8_matmul_stacked_fused", 0), d.get("q8_matmul_stacked", 0)
    checks = [
        (forwards % per == 0 and prefills % per == 0,
         f"stacked launches {forwards}/{prefills} are not whole passes of {per}"),
    ]
    forwards, prefills = forwards // per, prefills // per
    n = len(sl.requests)
    plain, gemv, attention = (q8_matmul_launches(s, forwards, prefills), gemv_launches(s, forwards, prefills),
                              decode_attention_launches(s, forwards))
    checks += [
        (forwards == (record.budget - 1) * prefills,
         f"{forwards} decode forwards for {prefills} prefills of a {record.budget}-token budget"),
        (0 < prefills <= n, f"{prefills} prefills for {n} requests in the slice"),
        (all(len(r.tokens or []) == record.budget for r in sl.requests), "a slice request decoded fewer tokens"),
        (d.get("q8_matmul", 0) == plain, f"q8_matmul launches {d.get('q8_matmul', 0)}, reckoned {plain}"),
        (sl.count_of("q8_gemv_kernel") == gemv,
         f"traced GEMV launches {sl.count_of('q8_gemv_kernel')}, reckoned {gemv}"),
        (sl.count_of("q8_gemv_kernel") + sl.count_of("q8_tile_kernel") == sum(
            d.get(k, 0) for k in ("q8_matmul", "q8_matmul_stacked", "q8_matmul_stacked_fused")),
         "traced Q8 launches differ from the program's counters"),
        (sl.count_of("attention_small_kernel") == attention,
         f"traced decode-attention launches {sl.count_of('attention_small_kernel')}, reckoned {attention}"),
        (sl.count_of("attention_small_kernel") + sl.count_of("attention_mma_kernel") == sum(
            d.get(k, 0) for k in ("decode_attention", "decode_attention_batched", "decode_attention_unstacked")),
         "traced attention launches differ from the program's counters"),
    ]
    for good, why in checks:
        if not good:
            note(f"no roofline: {why}")
            return None
    return {"forwards": forwards, "prefills": prefills, "requests": n}


def gemv_roofline(record: Record) -> Optional[float]:
    g = slice_groups(record)
    time_s = record.slice.time_of("q8_gemv_kernel") if g else 0.0
    fns = counts(record, "gemv_roofline", "gemv_step_bytes", "head_bytes") if g and time_s > 0 else None
    if fns is None:
        return None
    gemv_step_bytes, head_bytes = fns
    s = record.shapes
    w_step, row_step = gemv_step_bytes(s)
    w_head, row_head = head_bytes(s)
    rows = (record.budget - 1) * g["requests"]
    nbytes = g["forwards"] * w_step + rows * row_step + g["prefills"] * w_head + g["requests"] * row_head
    return 100.0 * nbytes / work.HBM_BYTES_PER_S / time_s


def attention_roofline(record: Record) -> Optional[float]:
    g = slice_groups(record)
    time_s = record.slice.time_of("attention_small_kernel") if g else 0.0
    fns = counts(record, "attention_roofline", "decode_attention_bytes") if g and time_s > 0 else None
    if fns is None:
        return None
    decode_attention_bytes, = fns
    s = record.shapes
    nbytes = sum(decode_attention_bytes(s, work.prompt_len(s, speech_samples(r)), record.budget - 1)
                 for r in record.slice.requests)
    return 100.0 * nbytes / work.HBM_BYTES_PER_S / time_s


def idle_share(record: Record) -> Optional[float]:
    sl = record.slice
    if sl is None or sl.window_s <= 0 or sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)


def stats_delta(record: Record, key: str) -> int:
    return int(record.stats_after.get(key, 0)) - int(record.stats_before.get(key, 0))


def dispatch_size(record: Record) -> Optional[float]:
    """Requests over decode dispatches: coalesced dispatches plus singles."""
    done = stats_delta(record, "transcription_count")
    batched = stats_delta(record, "batched_requests")
    dispatches = stats_delta(record, "batch_dispatches") + done - batched
    return done / dispatches if dispatches > 0 else None


def audio_seconds(req) -> float:
    return float(req.reply.get("duration", 0.0))


def steps_ms(lists) -> Optional[float]:
    steps = [t for lst in lists for t in lst]
    return 1000.0 * float(np.mean(steps)) if steps else None

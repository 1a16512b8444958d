"""Host spans inside the engine, read through the ``stats`` action.

A span times one host interval with ``time.perf_counter()`` and adds it to
process-wide aggregates, ``{name: (count, total seconds)}`` under one lock;
``performance_stats()`` reports them as ``spans``, process-lifetime
counters like ``batch_dispatches``. A span's mean over an interval is the
difference of two ``stats`` snapshots' ``total_ms`` over that of their
``count``. The spans sit at the layer boundaries of a request:

- ``wire.parse`` (a pipelined transcribe's line read → parsed and handed to
  the pool), ``wire.pool_wait`` (handed → a worker starts it),
  ``wire.audio`` (base64 → PCM → 16 kHz), ``wire.reply`` (the reply
  serialized → written and flushed);
- ``vad``: the VAD call, whose wall is the reply's ``vad_ms``;
- ``scheduler.queue`` (a job submitted → its dispatch starts, one a job) and
  ``scheduler.dispatch`` (the dispatch runs, a batch once; its wall feeds the
  scheduler's ``p50_ms``/``p95_ms``);
- ``model.encode`` and ``model.prefill``: the host's dispatch of log-mel and
  encoder, then of prompt embeds, decoder prefill and first logits, on every
  model path; neither adds a sync (the segment ticks' prefill ends at the
  draft window's read, which the tick needs);
- ``model.decode.step``: one decode step, closed by its one sync,
  ``model.decode.sync`` (the host waiting for the device); its wall is the
  step lists' entry;
- ``model.decode.capture`` (a decode loop's step captured as a CUDA graph,
  on its first step; the count is the number of captures) and
  ``model.decode.replay`` (a replay's launch), both inside
  ``model.decode.step`` (``models/qwen3_asr/step_graph.py``): replays over
  steps is the share of steps run from a graph.

A span's wall is the number the engine already reports for that interval,
so no boundary is timed twice.

While a ``torch.profiler`` runs (``torch.autograd.profiler.
_is_profiler_enabled``, a process-wide flag), a span also opens a
``record_function`` range named ``<name>[<request ids>]``. The engine runs on
the server, worker-pool and scheduler threads, so only a profiler that
records every thread (``torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)``) sees these ranges; it then shows them on the
device trace's clock, the spans of one request sharing its id. The ids are
those of :func:`requests` on the calling thread, which the server sets for a
request and the scheduler for a dispatch (every request of a batch). torch
is read only if the process has imported it.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Dict, Iterable, Iterator, Tuple


class Spans:
    """Counts and total seconds by span name, safe across threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, list] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            entry = self._totals.get(name)
            if entry is None:
                self._totals[name] = [1, seconds]
            else:
                entry[0] += 1
                entry[1] += seconds

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{name: {"count": n, "total_ms": x}}`` since the process started."""
        with self._lock:
            return {name: {"count": n, "total_ms": round(total * 1000.0, 3)}
                    for name, (n, total) in self._totals.items()}


_SPANS = Spans()
_local = threading.local()


def _profiler():
    """``torch.autograd.profiler`` while a profiler runs, else None."""
    torch = sys.modules.get("torch")
    profiler = getattr(getattr(torch, "autograd", None), "profiler", None)
    return profiler if getattr(profiler, "_is_profiler_enabled", False) else None


class _Span:
    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "_Span":
        self._range = None
        profiler = _profiler()
        if profiler is not None:
            ids = ",".join(str(r) for r in current_requests())
            self._range = profiler.record_function(f"{self.name}[{ids}]" if ids else self.name, ids or None)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        _SPANS.add(self.name, self.seconds)


def span(name: str) -> _Span:
    """Time the ``with`` block as ``name``; ``.seconds`` holds its wall after
    the block."""
    return _Span(name)


def record(name: str, seconds: float) -> None:
    """An interval timed by the caller: one that starts and ends on different
    threads, such as a queue wait."""
    _SPANS.add(name, seconds)


def snapshot() -> Dict[str, Dict[str, float]]:
    return _SPANS.snapshot()


def current_requests() -> Tuple:
    return getattr(_local, "rids", ())


@contextlib.contextmanager
def requests(rids: Iterable) -> Iterator[None]:
    """The request ids of this thread's spans inside the block."""
    previous = current_requests()
    _local.rids = tuple(rids)
    try:
        yield
    finally:
        _local.rids = previous

"""A decode step captured once as a CUDA graph and replayed for every token.

A decode loop hands :class:`StepGraph` its step body: a function of no
arguments that reads and writes only tensors that outlive the loop (the
token buffer, the done flags and the step count where the loop keeps them,
the weights, the KV cache and its device positions). Each call of the
``StepGraph`` is one step:

- eager (``capture=False``: the CPU, a mesh, f32 compute, a loop of one
  step), it runs the body;
- otherwise its first call captures the body into a graph of its own
  (:class:`CudaGraph`): on this thread's side stream, which first waits on
  the current one, in ``thread_local`` capture mode (the VAD, the wire
  threads and another decode loop keep launching on their own threads
  meanwhile; another loop's capture or release waits for it). A capture
  runs nothing, so the step is replayed at once; every later call replays
  it.

The host keeps the cache's host positions (``pos_host``, one ahead after
each step). A replay moves only the device's, so before it the host checks
them against the capacity, as the kernels' wrappers do in an eager step or a
capture. The op modules' ``LAUNCHES`` count what a capture records
(``ops._build.launch_tally``): that is taken off after the capture and added
back at every replay, so they equal the kernels the card ran. The graph
holds the addresses of the buffers it was captured on, so the loop releases
it, and its memory pool, when it ends (:meth:`StepGraph.close`, or the
``with`` block's end).

Spans (``runtime/tracing.py``): ``model.decode.capture`` around a capture,
``model.decode.replay`` around a replay's launch; the loop's
``model.decode.step`` holds both.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Tuple

import torch

from light_whisper_tpu_torch.ops import _build
from light_whisper_tpu_torch.runtime import tracing

_local = threading.local()
# Held through a capture and through a release: freeing a pool empties its
# cache, which syncs, and the allocator refuses that while any thread captures.
_capturing = threading.Lock()


def _side_stream(device: torch.device):
    """This thread's capture stream on ``device`` (a thread captures one
    graph at a time; another thread never shares it)."""
    streams = _local.__dict__.setdefault("streams", {})
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` with a memory pool of its own. The
    ``torch.cuda.graph`` context manager is not used: it runs
    ``gc.collect()`` and ``torch.cuda.empty_cache()`` on every entry."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.MemPool()

    def capture(self, body: Callable[[], None]) -> None:
        side = _side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with _capturing, torch.cuda.stream(side):
            self.graph.capture_begin(pool=self.pool.id, capture_error_mode="thread_local")
            try:
                body()
            except BaseException:
                with contextlib.suppress(RuntimeError):  # a capture the error broke cannot end cleanly
                    self.graph.capture_end()
                raise
            self.graph.capture_end()

    def replay(self) -> None:
        self.graph.replay()

    def release(self) -> None:
        """The graph, then its pool (which frees the pool's memory), while no
        thread captures."""
        with _capturing:
            self.graph.reset()
            self.graph = self.pool = None


class StepGraph:
    """One decode step a call: ``body`` eagerly, or captured on the first call
    and replayed (``capture``); ``cache`` is the loop's ``BatchKVCache``."""

    def __init__(self, body: Callable[[], None], cache, capture: bool) -> None:
        self._body, self._cache, self._capture = body, cache, capture
        self._graph = None
        self._launches: List[Tuple[Dict[str, int], str, int]] = []  # (counters, key, launches a replay)

    def __enter__(self) -> "StepGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __call__(self) -> None:
        cache = self._cache
        before = cache.pos_host
        if not self._capture:
            self._body()
        else:
            capacity = cache.k.shape[-2]  # the kernels' own bounds check runs only in the capture
            if not all(0 <= p < capacity for p in before):
                raise ValueError(f"positions {list(before)} exceed {capacity}")
            if self._graph is None:
                self._graph = self._record()
            with tracing.span("model.decode.replay"):
                self._graph.replay()
            for counters, key, n in self._launches:
                counters[key] += n
        cache.pos_host = [p + 1 for p in before]

    def _record(self):
        graph = CudaGraph(self._cache.k.device)
        tally: Dict[Tuple[int, str], list] = {}
        with tracing.span("model.decode.capture"), _build.launch_tally() as notes:
            try:
                graph.capture(self._body)
            except BaseException:
                graph.release()
                raise
            finally:  # recorded, not launched
                for counters, key in notes:
                    counters[key] -= 1
                    tally.setdefault((id(counters), key), [counters, key, 0])[2] += 1
        self._launches = [(counters, key, n) for counters, key, n in tally.values()]
        return graph

    def close(self) -> None:
        """Release the graph and its pool; the loop's buffers may go after."""
        if self._graph is not None:
            self._graph.release()
            self._graph = None

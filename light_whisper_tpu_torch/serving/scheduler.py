"""Multi-stream request scheduling for concurrent serving.

The port's copy of ``light_whisper_tpu/serving/scheduler.py``.

The reference enforces one in-flight engine request by holding a process
mutex across write+read (``funasr_service.rs:1353-1388``); multi-stream
concurrency (VAD + ASR + polish pipelines, BASELINE config #5) therefore
serializes at the engine. This scheduler keeps that serialization (one device
program at a time per model) but adds what a single-process engine can:

- a priority queue — finalize requests preempt interim ticks (a stuck
  finalize blocks a paste; a delayed interim tick only delays a subtitle),
- per-stream generations — a new request from the same stream invalidates
  queued stale ones (the request_id-discard pattern of the protocol, done
  before wasting device time instead of after),
- per-request latency stats (p50/p95) for the ``stats`` action: each job's
  ``scheduler.dispatch`` span wall (``runtime/tracing.py``). A job's wait
  from submit to its dispatch is recorded as ``scheduler.queue``; a dispatch
  carries the request ids of every job it runs.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from light_whisper_tpu_torch.runtime import tracing

PRIORITY_FINALIZE = 0
PRIORITY_INTERIM = 1


@dataclasses.dataclass(order=True)
class _Job:
    priority: int
    seq: int
    stream: str = dataclasses.field(compare=False)
    # None = not supersedable: the job ignores later generation bumps on its
    # stream (finalizes must survive interim ticks queued behind them).
    generation: Optional[int] = dataclasses.field(compare=False)
    work: Callable[[], Any] = dataclasses.field(compare=False)
    done: threading.Event = dataclasses.field(compare=False)
    result: Any = dataclasses.field(compare=False, default=None)
    error: Optional[BaseException] = dataclasses.field(compare=False, default=None)
    cancelled: bool = dataclasses.field(compare=False, default=False)
    # Batch-coalescing fields: jobs sharing a batch_key that are queued at
    # the moment one of them starts run as ONE batch_runner call.
    batch_key: Optional[str] = dataclasses.field(compare=False, default=None)
    payload: Any = dataclasses.field(compare=False, default=None)
    batch_runner: Optional[Callable[[List[Any]], List[Any]]] = dataclasses.field(
        compare=False, default=None
    )
    max_batch: int = dataclasses.field(compare=False, default=8)
    # when it was queued, and the request ids of the submitting thread
    submitted: float = dataclasses.field(compare=False, default_factory=time.perf_counter)
    rids: tuple = dataclasses.field(compare=False, default_factory=tracing.current_requests)


class EngineScheduler:
    def __init__(self) -> None:
        self._queue: List[_Job] = []
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._generations: Dict[str, int] = {}
        self._seq = itertools.count()
        # bounded: stats() reads the last 1000; an unbounded list leaks
        # ~14 MB/day on a 5-ticks/s server
        self._latencies: "collections.deque[float]" = collections.deque(maxlen=1000)
        self._batches = 0
        self._batched_jobs = 0
        self._running = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------

    def submit(
        self,
        stream: str,
        work: Callable[[], Any],
        priority: int = PRIORITY_INTERIM,
        supersede: bool = True,
    ) -> _Job:
        """Queue work for a stream. ``supersede`` bumps the stream generation
        so queued-but-unstarted older supersedable requests of that stream
        are dropped; ``supersede=False`` jobs (finalizes) are themselves
        IMMUNE to later bumps — an interim tick of the next recording must
        not cancel a queued finalize (the paste would be lost to a subtitle
        tick, inverting the priority design)."""
        with self._lock:
            if not self._running:
                raise RuntimeError("engine scheduler is shut down")
            if supersede:
                self._generations[stream] = self._generations.get(stream, 0) + 1
                generation: Optional[int] = self._generations[stream]
            else:
                generation = None
            job = _Job(
                priority=priority,
                seq=next(self._seq),
                stream=stream,
                generation=generation,
                work=work,
                done=threading.Event(),
            )
            heapq.heappush(self._queue, job)
            self._wakeup.notify()
        return job

    def submit_batchable(
        self,
        stream: str,
        payload: Any,
        batch_key: str,
        batch_runner: Callable[[List[Any]], List[Any]],
        priority: int = PRIORITY_INTERIM,
        supersede: bool = True,
        max_batch: int = 8,
    ) -> _Job:
        """Queue work that may coalesce with other queued jobs of the same
        ``batch_key``: when the worker reaches any of them, it drains up to
        ``max_batch`` live same-key jobs and runs ``batch_runner(payloads)``
        once, distributing results positionally. Hardware-efficient
        multi-stream serving: concurrent interim ticks become ONE
        ``transcribe_batch`` dispatch instead of N sequential ones."""
        with self._lock:
            if not self._running:
                raise RuntimeError("engine scheduler is shut down")
            if supersede:
                self._generations[stream] = self._generations.get(stream, 0) + 1
                generation: Optional[int] = self._generations[stream]
            else:
                generation = None  # immune to later bumps (see submit())
            job = _Job(
                priority=priority,
                seq=next(self._seq),
                stream=stream,
                generation=generation,
                work=lambda: batch_runner([payload])[0],  # solo fallback
                done=threading.Event(),
                batch_key=batch_key,
                payload=payload,
                batch_runner=batch_runner,
                max_batch=max_batch,
            )
            heapq.heappush(self._queue, job)
            self._wakeup.notify()
        return job

    def wait(self, job: _Job, timeout: Optional[float] = None) -> Any:
        if not job.done.wait(timeout):
            raise TimeoutError("engine request timed out")
        if job.cancelled:
            raise RuntimeError("superseded by a newer request on this stream")
        if job.error is not None:
            raise job.error
        return job.result

    def stats(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._latencies)
            batches, batched_jobs = self._batches, self._batched_jobs
        if not lat:
            return {"count": 0}
        return {
            "count": len(lat),
            "p50_ms": round(lat[len(lat) // 2] * 1000, 3),
            "p95_ms": round(lat[int(len(lat) * 0.95)] * 1000, 3),
            "batches": batches,
            "batched_jobs": batched_jobs,
        }

    def shutdown(self) -> None:
        with self._lock:
            self._running = False
            self._wakeup.notify()
        self._worker.join(timeout=5)

    # ------------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._running and not self._queue:
                    self._wakeup.wait()
                if not self._running:
                    # flush: cancel everything still queued
                    for job in self._queue:
                        job.cancelled = True
                        job.done.set()
                    self._queue.clear()
                    return
                job = heapq.heappop(self._queue)
                stale = (
                    job.generation is not None
                    and job.generation != self._generations.get(job.stream, 0)
                )
                members: List[_Job] = []
                if not stale and job.batch_key is not None:
                    members = self._drain_batch_members(job)
            if stale:
                job.cancelled = True
                job.done.set()
                continue
            batch = [job, *members]
            started = time.perf_counter()
            for j in batch:
                tracing.record("scheduler.queue", started - j.submitted)
            dispatch = tracing.span("scheduler.dispatch")
            try:
                with tracing.requests(r for j in batch for r in j.rids), dispatch:
                    self._dispatch(job, batch)
            finally:
                with self._lock:
                    self._latencies.extend([dispatch.seconds] * len(batch))
                    if members:
                        self._batches += 1
                        self._batched_jobs += len(batch)
                for j in batch:
                    j.done.set()

    @staticmethod
    def _dispatch(job: _Job, batch: List[_Job]) -> None:
        """Run one job, or a coalesced batch as one ``batch_runner`` call;
        errors are surfaced via ``wait()``."""
        if len(batch) == 1:
            try:
                job.result = job.work()
            except BaseException as exc:
                job.error = exc
            return
        try:
            results = job.batch_runner([j.payload for j in batch])
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batch_runner returned {len(results)} results "
                    f"for {len(batch)} jobs"
                )
            for j, res in zip(batch, results):
                j.result = res
        except BaseException as exc:
            for j in batch:
                j.error = exc

    def _drain_batch_members(self, lead: _Job) -> List[_Job]:
        """Pull queued live jobs sharing ``lead.batch_key`` (lock held).

        One queued job per stream: with supersede semantics only the newest
        generation is live anyway, and a stream's requests must stay ordered."""
        members: List[_Job] = []
        taken_streams = {lead.stream}
        kept: List[_Job] = []
        while self._queue and len(members) + 1 < lead.max_batch:
            other = heapq.heappop(self._queue)
            if (
                other.batch_key == lead.batch_key
                # Same runner required: distinct submitters may share a key
                # string but expect different payload shapes — feeding one
                # runner the other's payloads crashes or mis-decodes.
                # == not `is`: bound methods are fresh objects per access
                # but compare equal on (func, instance).
                and other.batch_runner == lead.batch_runner
                and other.stream not in taken_streams
                and (
                    other.generation is None
                    or other.generation == self._generations.get(other.stream, 0)
                )
            ):
                members.append(other)
                taken_streams.add(other.stream)
            else:
                kept.append(other)
        for j in kept:
            heapq.heappush(self._queue, j)
        return members

"""Per-stream session pool with bounded LRU eviction (counterpart of
``serving/session_pool.py``).

The engine pipelines transcribes, so two interleaved dictation streams sharing
one :class:`SessionBridge` would reset each other's KV prefix every tick.
Sessions are keyed by the request's ``options.stream``; requests that name no
stream share ``DEFAULT_STREAM``. Each live session owns one KV cache on the
device (117 MB at 0.6B and 1024 slots), so the pool holds at most
``LWT_MAX_SESSIONS`` (default 4); an evicted session just resets, which gives
a stateless transcribe's result.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import Counter, OrderedDict
from typing import Dict, Iterator, Optional, Sequence

from light_whisper_tpu_torch.serving.session_bridge import SessionBridge

DEFAULT_STREAM = "__default__"
DEFAULT_MAX_SESSIONS = 4


def max_sessions() -> int:
    try:
        return max(1, int(os.environ.get("LWT_MAX_SESSIONS", DEFAULT_MAX_SESSIONS)))
    except ValueError:
        return DEFAULT_MAX_SESSIONS


class SessionPool:
    """LRU pool of per-stream :class:`SessionBridge` instances."""

    def __init__(self, model, limit: Optional[int] = None) -> None:
        self.model = model
        self.limit = limit if limit is not None else max_sessions()
        self._lock = threading.Lock()
        self._bridges: "OrderedDict[str, SessionBridge]" = OrderedDict()
        # keys checked out for a transcription: eviction skips them (a reset
        # would drop the cache a tick on another thread is writing)
        self._pinned: Counter = Counter()
        self.evictions = 0
        # counters of evicted bridges, so the totals stay monotonic
        self._retired_hits = 0
        self._retired_resets = 0

    def bridge_for(self, stream: Optional[str]) -> SessionBridge:
        with self._lock:
            return self._bridge_for_locked(stream or DEFAULT_STREAM)

    def _bridge_for_locked(self, key: str) -> SessionBridge:
        bridge = self._bridges.get(key)
        if bridge is not None:
            self._bridges.move_to_end(key)
            return bridge
        bridge = SessionBridge(self.model)
        self._bridges[key] = bridge
        # evict the oldest unpinned bridges; with everything pinned the pool
        # may exceed its limit for a while
        evictable = [k for k in self._bridges if k != key and not self._pinned[k]]
        while len(self._bridges) > self.limit and evictable:
            evicted = self._bridges.pop(evictable.pop(0))
            evicted.reset()  # frees its KV cache
            self._retired_hits += evicted.session_hits
            self._retired_resets += evicted.session_resets
            self.evictions += 1
        return bridge

    @contextlib.contextmanager
    def checkout(self, streams: Sequence[Optional[str]]) -> Iterator[list]:
        """Pin and fetch the bridges of ``streams`` for one transcription."""
        keys = [s or DEFAULT_STREAM for s in streams]
        with self._lock:
            for key in keys:
                self._pinned[key] += 1
            bridges = [self._bridge_for_locked(key) for key in keys]
        try:
            yield bridges
        finally:
            with self._lock:
                for key in keys:
                    self._pinned[key] -= 1
                    if self._pinned[key] <= 0:
                        del self._pinned[key]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            per_stream = {key: {"hits": b.session_hits, "resets": b.session_resets}
                          for key, b in self._bridges.items()}
            hits = self._retired_hits + sum(s["hits"] for s in per_stream.values())
            resets = self._retired_resets + sum(s["resets"] for s in per_stream.values())
            parked = sum(b.retained_bytes for b in self._bridges.values())
        return {
            "session_hits": hits,
            "session_resets": resets,
            "session_hit_rate": round(hits / max(1, hits + resets), 4),
            "session_streams": per_stream,
            "session_evictions": self.evictions,
            # host bytes parked for prefix memcmps: at most
            # LWT_SESSION_PARK_MAX_BYTES a stream
            "session_parked_audio_bytes": parked,
        }

    def __len__(self) -> int:
        with self._lock:
            return len(self._bridges)

"""The program's own host spans over the window: ``stats``' ``spans``
(``light_whisper_tpu_torch/runtime/tracing.py``: a count and a total a span
name since the engine started), after the window less before it.

The window's delta holds the traced slice's requests too (their spans ran
under the profiler). Every reader returns ``None`` where either snapshot has
no ``spans``: an engine that records none.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def window(record) -> Optional[Dict[str, Tuple[int, float]]]:
    """``{name: (count, total ms)}`` of the spans recorded in the window."""
    before, after = record.stats_before.get("spans"), record.stats_after.get("spans")
    if before is None or after is None:
        return None
    out = {}
    for name, a in after.items():
        b = before.get(name, {"count": 0, "total_ms": 0.0})
        out[name] = (int(a["count"]) - int(b["count"]), float(a["total_ms"]) - float(b["total_ms"]))
    return out


def mean_ms(record, name: str) -> Optional[float]:
    """Mean wall of a ``name`` span in the window."""
    spans = window(record)
    count, total = (spans or {}).get(name, (0, 0.0))
    return total / count if count > 0 else None


def decode_host_ms(record) -> Optional[float]:
    """A decode step's wall less its sync, the host waiting for the device:
    the host's own time a step."""
    spans = window(record)
    steps, step_ms = (spans or {}).get("model.decode.step", (0, 0.0))
    _syncs, sync_ms = (spans or {}).get("model.decode.sync", (0, 0.0))
    return (step_ms - sync_ms) / steps if steps > 0 else None


WIRE_SPANS = ("wire.parse", "wire.pool_wait", "wire.audio", "wire.reply")


def wire_server_ms(record) -> Optional[float]:
    """The server's own wire work a request: its line parsed, its wait for a
    worker, its audio decoded and its reply written."""
    spans = window(record)
    replies = (spans or {}).get("wire.reply", (0, 0.0))[0]
    if replies <= 0:
        return None
    return sum(spans.get(name, (0, 0.0))[1] for name in WIRE_SPANS) / replies

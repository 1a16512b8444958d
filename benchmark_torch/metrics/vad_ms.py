"""Median of the replies' vad_ms: the VAD trim of each request."""

from harness.measures import median


def read(record):
    return median(r.reply["vad_ms"] for r in record.served())

"""Median of a request's inference_ms less its decode steps' walls: log-mel, encoder and prefill."""

from harness.measures import median


def read(record):
    return median(r.reply["inference_ms"] - 1000.0 * sum(r.steps) for r in record.served() if r.steps)

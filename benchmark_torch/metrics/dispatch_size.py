"""Requests over decode dispatches in the window: stats batch_dispatches plus the singles (transcription_count - batched_requests), before and after."""

from harness.measures import dispatch_size


def read(record):
    return dispatch_size(record)

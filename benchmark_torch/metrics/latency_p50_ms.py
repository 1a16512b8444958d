"""Median client wall, writing the request line to reading its reply, over every request answered in the window."""

from harness.measures import percentile_ms


def read(record):
    return percentile_ms(record, 50)

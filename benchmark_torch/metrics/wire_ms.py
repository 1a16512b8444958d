"""Median of the client wall less the reply's own inference_ms and vad_ms: the wire, the server loop and the wait for the device (a batch)."""

from harness.measures import wire_ms


def read(record):
    return wire_ms(record)

"""Model FLOPs the window's requests needed (encoder, prefill, decode, head) over the window's wall times the bf16 peak, in %."""

from harness.measures import mfu_percent


def read(record):
    return mfu_percent(record)

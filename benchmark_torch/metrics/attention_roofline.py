"""Decode attention (attention_small_kernel): the K/V bytes of its launches in the traced slice over 3.35 TB/s, over their device time, in %."""

from harness.measures import attention_roofline


def read(record):
    return attention_roofline(record)

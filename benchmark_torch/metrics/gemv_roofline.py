"""Q8 GEMV (q8_gemv_kernel, T <= 8): the bytes its launches in the traced slice need over 3.35 TB/s, over their device time, in %."""

from harness.measures import gemv_roofline


def read(record):
    return gemv_roofline(record)

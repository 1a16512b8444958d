"""Mean host wall of a decode step, every step of every request (the per-step walls the path fills)."""

from harness.measures import step_lists, steps_ms


def read(record):
    return steps_ms(step_lists(record))

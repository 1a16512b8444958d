"""Mean wait of a request in the scheduler's queue, submit to the start of its dispatch (the scheduler.queue span)."""

from harness.spans import mean_ms


def read(record):
    return mean_ms(record, "scheduler.queue")

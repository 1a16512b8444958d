"""90th percentile (linear between ranks) of the client walls of every request answered in the window; a failed request counts as never answered."""

from harness.measures import percentile_ms


def read(record):
    return percentile_ms(record, 90)

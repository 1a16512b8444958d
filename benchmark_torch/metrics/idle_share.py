"""Share of the traced slice's wall in which no device operation ran, in %."""

from harness.measures import idle_share


def read(record):
    return idle_share(record)

"""Mean host wall of the log-mel and audio encoder's dispatch, ending without a sync (the model.encode span)."""

from harness.spans import mean_ms


def read(record):
    return mean_ms(record, "model.encode")

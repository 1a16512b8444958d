"""Mean host wall of a decode step over every step of the window, batched or not (the model.decode.step span)."""

from harness.spans import mean_ms


def read(record):
    return mean_ms(record, "model.decode.step")

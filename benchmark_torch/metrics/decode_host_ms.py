"""Host time of a decode step: its wall less its one sync (model.decode.step minus model.decode.sync), per step."""

from harness.spans import decode_host_ms


def read(record):
    return decode_host_ms(record)

"""The server's wire work a request: the wire.parse, wire.pool_wait, wire.audio and wire.reply spans' totals over the replies."""

from harness.spans import wire_server_ms


def read(record):
    return wire_server_ms(record)

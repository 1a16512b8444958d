"""Seconds of audio in the requests answered (successfully) in the window, over the window's wall seconds."""

from harness.measures import audio_seconds, ok


def read(record):
    done = [r for r in record.in_window() if ok(r)]
    return sum(audio_seconds(r) for r in done) / record.seconds if done else None

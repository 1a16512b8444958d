"""Share of the window's decode steps that ran from a captured CUDA graph: 100 x model.decode.replay count / model.decode.step count. Nothing where the program records no replay span."""

from harness.spans import window


def read(record):
    spans = window(record)
    if not spans or "model.decode.replay" not in spans:
        return None
    steps = spans.get("model.decode.step", (0, 0.0))[0]
    return 100.0 * spans["model.decode.replay"][0] / steps if steps > 0 else None

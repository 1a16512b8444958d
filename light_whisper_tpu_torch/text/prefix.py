"""Stable-prefix smoothing for streaming hypotheses.

The port's copy of ``light_whisper_tpu/text/prefix.py``: the interim loop's
display logic (``interim.rs:198-215`` in the app). The common prefix between
the previous and the current hypothesis renders as stable text; the
divergent tail is tentative. The app computes the prefix on UTF-8 byte
positions but only ever cuts at character boundaries; code points here are
equivalent.
"""

from __future__ import annotations

from typing import NamedTuple


class InterimSegments(NamedTuple):
    stable: str
    tentative: str


def common_prefix_len(a: str, b: str) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def interim_segments(previous: str, current: str) -> InterimSegments:
    """Split the current hypothesis into (stable, tentative) vs the previous."""
    cut = common_prefix_len(previous, current)
    return InterimSegments(stable=current[:cut], tentative=current[cut:])


class StablePrefixTracker:
    """Carries hypothesis state across interim ticks.

    The stable prefix is taken against the *previous* hypothesis only: a
    regression in the new hypothesis shrinks the stable region.
    """

    def __init__(self) -> None:
        self._previous = ""

    def update(self, hypothesis: str) -> InterimSegments:
        segments = interim_segments(self._previous, hypothesis)
        self._previous = hypothesis
        return segments

    def reset(self) -> None:
        self._previous = ""

    @property
    def last_hypothesis(self) -> str:
        return self._previous

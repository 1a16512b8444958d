"""Traffic from a mix file and a seed.

A mix (``traffic/<name>.json``) fixes the loop, the number of clients, the
number of distinct clips and their lengths; the seed draws only what the
clips say (each its own voice, ``speechlike.voice``, and prosody) and the
order in which each client sends them. Every seed
therefore offers the same set of sizes: the ``clips`` quantiles of the
speech-length distribution (``fixed``: one length), each a speech-like clip
between a lead and a trail of near-silence, in samples a multiple of the
10 ms hop.

The clips are dealt to the clients in turn, so no two clients share one, and
each client cycles through its own in a new order each round.
"""

from __future__ import annotations

import base64
import dataclasses
import statistics
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from harness import speechlike as speechlike_mod

SAMPLE_RATE = 16_000
HOP = 160
MAX_PHASE_SECONDS = 2.0  # a clip starts this far at most into a longer render, so seeds differ in prosody
RENDER_THREADS = 4


@dataclasses.dataclass
class Traffic:
    utterances: List[np.ndarray]  # int16 PCM
    payloads: List[str]  # base64 of each utterance's little-endian PCM
    orders: List[List[int]]  # per client: utterance indices, cycled
    clients: int


def speech_lengths(mix: Dict) -> List[float]:
    """The mix's speech lengths in seconds, one a clip: the quantiles
    (i + 1/2)/n of its distribution, clipped to [min, max]."""
    d = mix["speech_seconds"]
    n = int(mix["clips"])
    if d["distribution"] == "fixed":
        return [float(d["seconds"])] * n
    if d["distribution"] != "lognormal":
        raise ValueError(f"unknown length distribution {d['distribution']!r}")
    unit = statistics.NormalDist()
    return [float(np.clip(d["median"] * np.exp(d["sigma"] * unit.inv_cdf((i + 0.5) / n)), d["min"], d["max"]))
            for i in range(n)]


def _samples(seconds: float) -> int:
    return max(HOP, int(round(seconds * SAMPLE_RATE / HOP)) * HOP)


def _draw(mix: Dict, speech_s: float, rng: np.random.Generator) -> Dict:
    """What the seed decides about one clip, drawn in a fixed order."""
    lead, trail = _samples(mix["lead_silence_seconds"]), _samples(mix["trail_silence_seconds"])
    noise = lambda n: np.round(rng.standard_normal(n) * mix["silence_noise_lsb"]).astype(np.int16)  # noqa: E731
    phase = int(rng.integers(0, int(MAX_PHASE_SECONDS * SAMPLE_RATE) // HOP + 1)) * HOP
    return {"speech": _samples(speech_s), "phase": phase, "seed": int(rng.integers(0, 2**63)),
            "voice": speechlike_mod.voice(rng), "lead": noise(lead), "trail": noise(trail)}


def _render(d: Dict) -> np.ndarray:
    phase, speech = d["phase"], d["speech"]
    clip = speechlike_mod.speechlike((phase + speech) / SAMPLE_RATE, seed=d["seed"], voice=d["voice"])[
        phase : phase + speech]
    pcm = np.clip(np.round(clip * 32768.0), -32768, 32767).astype(np.int16)
    return np.concatenate([d["lead"], pcm, d["trail"]])


def _order(rng: np.random.Generator, clips: List[int], cycles: int) -> List[int]:
    """``cycles`` permutations of ``clips``, none twice in a row (a client
    never re-sends the clip it just sent: that would extend its session)."""
    out: List[int] = []
    for _ in range(cycles):
        perm = [clips[int(i)] for i in rng.permutation(len(clips))]
        if out and len(perm) > 1 and perm[0] == out[-1]:
            perm[0], perm[1] = perm[1], perm[0]
        out += perm
    return out


def generate(mix: Dict, seed: int) -> Traffic:
    if mix["loop"] != "closed":
        raise ValueError(f"unknown loop {mix['loop']!r}")
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 0x5EED]))
    draws = [_draw(mix, s, rng) for s in speech_lengths(mix)]
    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        utterances = list(pool.map(_render, draws))
    payloads = [base64.b64encode(u.astype("<i2").tobytes()).decode() for u in utterances]
    clients = int(mix["clients"])
    if len(utterances) < clients:
        raise ValueError(f"{len(utterances)} clips for {clients} clients")
    orders = [_order(rng, list(range(c, len(utterances), clients)), int(mix["cycles"])) for c in range(clients)]
    return Traffic(utterances, payloads, orders, clients)

"""Plain FireRedVAD: the trim the engine applies before the model, computed
apart from the program.

FireRedVAD (FireRedTeam, Apache-2.0) is a DFSMN frame classifier over
Kaldi-style 80-bin log-mel fbank: two ReLU layers, a memory block of 20
lookback and 20 lookahead depthwise taps, seven residual DFSMN blocks, a
ReLU layer and a sigmoid. Its published weights are kept beside this file
(``reference_data/fireredvad.gguf``, float32). The engine trims leading and
trailing non-speech: the first segment's start to the last one's end, where
segments come from the smoothed probabilities by hysteresis (open after 150
ms of speech, close after 300 ms of silence, 120 ms of padding each side).
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reference_data",
                       "fireredvad.gguf")
RATE, FRAME, SHIFT, NFFT, BINS = 16_000, 400, 160, 512, 80
THRESHOLD, SMOOTH, MIN_SPEECH, MIN_SILENCE, PAD = 0.5, 5, 15, 30, 1920
TAPS = 20


def read_f32_gguf(path: str) -> Dict[str, np.ndarray]:
    """The float32 tensors of a GGUF v3 file (metadata skipped)."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0

    def take(fmt):
        nonlocal pos
        vals = struct.unpack_from(fmt, buf, pos)
        pos += struct.calcsize(fmt)
        return vals[0] if len(vals) == 1 else vals

    def skip_value(vtype):
        nonlocal pos
        sizes = {0: 1, 1: 1, 2: 2, 3: 2, 4: 4, 5: 4, 6: 4, 7: 1, 10: 8, 11: 8, 12: 8}
        if vtype in sizes:
            pos += sizes[vtype]
        elif vtype == 8:
            n = take("<Q")
            pos += n
        elif vtype == 9:
            elem, count = take("<I"), take("<Q")
            for _ in range(count):
                skip_value(elem)
        else:
            raise ValueError(f"metadata type {vtype}")

    magic, _version, n_tensors, n_kv = take("<IIQQ")
    if magic != 0x46554747:
        raise ValueError(f"{path}: not GGUF")
    alignment = 32
    for _ in range(n_kv):
        n = take("<Q")
        key = buf[pos: pos + n].decode()
        pos += n
        vtype = take("<I")
        if key == "general.alignment":
            alignment = take("<I")
        else:
            skip_value(vtype)
    infos = []
    for _ in range(n_tensors):
        n = take("<Q")
        name = buf[pos: pos + n].decode()
        pos += n
        dims = [take("<Q") for _ in range(take("<I"))]
        gtype, offset = take("<I"), take("<Q")
        if gtype != 0:
            raise ValueError(f"{name}: type {gtype} is not float32")
        infos.append((name, tuple(reversed(dims)), offset))
    start = -(-pos // alignment) * alignment
    return {name: np.frombuffer(buf, "<f4", int(np.prod(shape)), start + off).reshape(shape).copy()
            for name, shape, off in infos}


def _kaldi_mel() -> np.ndarray:
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)  # noqa: E731
    lo, hi = mel(20.0), mel(RATE / 2.0)
    step = (hi - lo) / (BINS + 1)
    centers = mel(RATE / NFFT * np.arange(NFFT // 2))
    w = np.zeros((NFFT // 2 + 1, BINS))
    for b in range(BINS):
        left, mid, right = lo + b * step, lo + (b + 1) * step, lo + (b + 2) * step
        w[: NFFT // 2, b] = np.clip(np.minimum((centers - left) / (mid - left), (right - centers) / (right - mid)),
                                   0.0, None)
    return w


class Vad:
    def __init__(self, device):
        self.device = torch.device(device)
        t = read_f32_gguf(WEIGHTS)
        self.w = {k: torch.as_tensor(v, device=self.device) for k, v in t.items()}
        n = np.arange(FRAME)
        self.window = torch.as_tensor((0.5 - 0.5 * np.cos(2 * math.pi * n / (FRAME - 1))) ** 0.85,
                                      device=self.device)
        self.mel = torch.as_tensor(_kaldi_mel(), device=self.device)

    def _fbank(self, pcm: torch.Tensor) -> torch.Tensor:
        frames = 1 + (pcm.shape[0] - FRAME) // SHIFT
        x = pcm.double().unfold(0, FRAME, SHIFT)[:frames]
        x = x - x.mean(dim=1, keepdim=True)
        x = torch.cat([x[:, :1] * (1 - 0.97), x[:, 1:] - 0.97 * x[:, :-1]], dim=1)
        spec = torch.fft.rfft(torch.nn.functional.pad(x * self.window, (0, NFFT - FRAME)), dim=1)
        power = spec.real ** 2 + spec.imag ** 2
        return torch.log(torch.clamp_min(power @ self.mel, float(np.finfo(np.float32).eps))).float()

    def _memory(self, x: torch.Tensor, stem: str) -> torch.Tensor:
        back, ahead = self.w[f"{stem}.back"], self.w[f"{stem}.ahead"]  # [C, 20] each
        T = x.shape[0]
        xp = torch.nn.functional.pad(x, (0, 0, TAPS - 1, TAPS))  # frames t-19 .. t+20
        out = torch.zeros_like(x)
        for j in range(TAPS):  # lookback tap j sees frame t - 19 + j
            out += xp[j : j + T] * back[:, j]
        for j in range(TAPS):  # lookahead tap j sees frame t + 1 + j
            out += xp[TAPS + j : TAPS + j + T] * ahead[:, j]
        return x + out

    def probabilities(self, audio_f32: np.ndarray) -> np.ndarray:
        w = self.w
        pcm = torch.clamp(torch.as_tensor(audio_f32, device=self.device) * 32768.0, -32768.0, 32767.0)
        if pcm.shape[0] < FRAME:
            return np.zeros(0, np.float32)
        feat = (self._fbank(pcm) - w["cmvn.mean"]) * w["cmvn.inv_std"]
        h = torch.relu(feat @ w["fc1.w"] + w["fc1.b"])
        h = torch.relu(h @ w["fc2.w"] + w["fc2.b"])
        prev = self._memory(h, "fsmn1")
        for i in range(7):
            z = torch.relu(prev @ w[f"blocks.{i}.fc1.w"] + w[f"blocks.{i}.fc1.b"]) @ w[f"blocks.{i}.fc2.w"]
            prev = self._memory(z, f"blocks.{i}") + prev
        h = torch.relu(prev @ w["dnn.w"] + w["dnn.b"])
        return torch.sigmoid((h @ w["out.w"] + w["out.b"])[:, 0]).cpu().numpy()

    def segments(self, audio_f32: np.ndarray) -> List[Tuple[int, int]]:
        probs = self.probabilities(audio_f32).astype(np.float64)
        n = probs.size
        smooth = np.array([probs[max(0, t - SMOOTH + 1): t + 1].mean() for t in range(n)])
        flags = smooth >= THRESHOLD
        raw, run, active, gap = [], None, None, None
        for t, speech in enumerate(flags):
            if active is None:
                if speech:
                    run = t if run is None else run
                    if t - run + 1 >= MIN_SPEECH:
                        active, gap = run, None
                else:
                    run = None
            elif speech:
                gap = None
            elif gap is None:
                gap = t
            elif t - gap + 1 >= MIN_SILENCE:
                raw.append((active, gap))
                active = run = gap = None
        if active is not None:
            raw.append((active, n))
        merged: List[Tuple[int, int]] = []
        for a, b in raw:
            s, e = max(0, a * SHIFT - PAD), min(len(audio_f32), b * SHIFT + PAD)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    def trim(self, pcm: np.ndarray) -> Tuple[np.ndarray, int]:
        """(the samples the engine keeps, the number of speech segments)."""
        audio = pcm.astype(np.float32) / np.float32(32768.0)
        segs = self.segments(audio)
        if not segs or segs[-1][1] <= segs[0][0]:
            return pcm[:0], 0
        return pcm[segs[0][0]: segs[-1][1]], len(segs)

"""FireRedVAD runtime on the card (counterpart of ``models/vad/api.py``).

Same surface the engine server calls: ``probabilities`` / ``warmup`` /
``speech_timestamps`` on 16 kHz float32 PCM. fbank, CMVN and the DFSMN run
on ``device``; segmentation runs on the host (``segmenter.speech_segments``).
Lengths are not padded to buckets. The reference's native C++ segmenter has
the same semantics as ``speech_segments`` and is not ported.

:class:`VadPrefixSession` serves the interim loop's growing buffer by
recomputing only its tail (the reference's halo path; its host-numpy
``StreamingVad`` cascade serves a host VAD and is not ported).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from light_whisper_tpu_torch.audio import fbank as kfb
from light_whisper_tpu_torch.audio.fbank import SAMPLE_RATE
from light_whisper_tpu_torch.formats import gguf
from light_whisper_tpu_torch.models.vad import dfsmn
from light_whisper_tpu_torch.models.vad.segmenter import SegmenterOptions, speech_segments

BUNDLED_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fireredvad.gguf")
_FINE_MAX = 16 * SAMPLE_RATE  # the reference's last fine 0.5 s bucket
_HALO_FRAMES = 200  # > the DFSMN's 160-frame receptive field each way


class FireRedVad:
    """FireRedVAD with fbank + DFSMN on ``device``."""

    def __init__(
        self,
        weights_path: Optional[str] = None,
        options: Optional[SegmenterOptions] = None,
        device="cuda",
    ):
        self.options = options or SegmenterOptions()
        self.device = torch.device(device)
        path = weights_path or BUNDLED_WEIGHTS
        if not os.path.isfile(path):
            raise FileNotFoundError(f"FireRedVAD weights not found: {path}")
        f = gguf.read_gguf(path)
        try:
            arch = f.metadata.get("general.architecture")
            if arch != "fireredvad-dfsmn":
                raise ValueError(f"{path}: unexpected architecture {arch!r}")
            flat: Dict[str, np.ndarray] = {
                name: t.array() for name, t in f.tensors.items() if not name.startswith("cmvn.")
            }
            self._params = dfsmn.prepare_params(flat, self.device)
            self._cmvn_mean = torch.as_tensor(
                np.asarray(f.tensors["cmvn.mean"].array(), np.float32), device=self.device
            )
            self._cmvn_inv_std = torch.as_tensor(
                np.asarray(f.tensors["cmvn.inv_std"].array(), np.float32), device=self.device
            )
        finally:
            f.close()

    def probabilities(self, audio: np.ndarray) -> np.ndarray:
        samples = np.asarray(audio, dtype=np.float32).reshape(-1)
        frames = kfb.num_frames(len(samples))
        if frames == 0:
            return np.empty(0, dtype=np.float32)
        # f32 convolutions must not run in TF32 on the card
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            wave = torch.from_numpy(samples).to(self.device)
            pcm = torch.clamp(wave * 32768.0, -32768.0, 32767.0)
            feat = kfb.fbank(pcm)
            feat = (feat - self._cmvn_mean) * self._cmvn_inv_std
            probs = dfsmn.dfsmn_probs(self._params, feat, frames)
        return probs.cpu().numpy()

    def warmup(self) -> None:
        self.probabilities(np.zeros(SAMPLE_RATE, dtype=np.float32))

    def speech_timestamps(
        self, audio: np.ndarray, probs: Optional[np.ndarray] = None
    ) -> List[Dict[str, int]]:
        samples = np.asarray(audio, dtype=np.float32).reshape(-1)
        if probs is None:
            probs = self.probabilities(samples)
        return speech_segments(probs, len(samples), self.options)


class VadPrefixSession:
    """Probabilities of a growing audio buffer, recomputing only its tail.

    Frames more than the receptive field behind the previous end do not change
    when audio is appended (the DFSMN sees ±160 frames; fbank frames are
    sample-local), so a tick runs :meth:`FireRedVad.probabilities` on the new
    audio plus two halos of context and stitches the result onto the cached
    prefix: equal to the whole pass up to float reassociation. Reuse applies
    while the buffer byte-extends the previous one and stays within 16 s;
    anything else recomputes fresh (the stateless behaviour). Retention is one
    buffer of at most 16 s and its probabilities."""

    def __init__(self, vad: FireRedVad):
        self._vad = vad
        self._samples: Optional[np.ndarray] = None
        self._probs: Optional[np.ndarray] = None
        # ticks of one stream (or anonymous clients sharing the default
        # stream) may run on two worker threads at once
        self._tick_lock = threading.Lock()
        self.reused_ticks = 0

    def retained_bytes(self) -> int:
        """Host bytes parked between ticks."""
        with self._tick_lock:
            return sum(int(a.nbytes) for a in (self._samples, self._probs) if a is not None)

    def probabilities(self, audio: np.ndarray) -> np.ndarray:
        with self._tick_lock:
            return self._probabilities_locked(audio)

    def _probabilities_locked(self, audio: np.ndarray) -> np.ndarray:
        samples = np.asarray(audio, dtype=np.float32).reshape(-1)
        prev, prev_probs = self._samples, self._probs
        extends = not (
            prev is None
            or prev_probs is None
            or len(samples) < len(prev)
            or len(samples) > _FINE_MAX
            or len(prev_probs) == 0
            or not np.array_equal(samples[: len(prev)], prev)
        )
        if not extends:
            probs = self._vad.probabilities(samples)
            if 0 < len(samples) <= _FINE_MAX:
                self._samples, self._probs = samples, probs
            else:
                self._samples = self._probs = None
            return probs
        keep = max(0, len(prev_probs) - _HALO_FRAMES)
        fs = max(0, keep - _HALO_FRAMES)  # keep - fs >= the halo > the receptive field
        tail = self._vad.probabilities(samples[fs * kfb.FRAME_SHIFT :])
        probs = np.concatenate([prev_probs[:keep], tail[keep - fs :]])
        if len(probs) != kfb.num_frames(len(samples)):
            raise RuntimeError(f"stitched {len(probs)} frames for {kfb.num_frames(len(samples))}")
        self.reused_ticks += 1
        self._samples, self._probs = samples, probs
        return probs

    def speech_timestamps(self, audio: np.ndarray) -> List[Dict[str, int]]:
        samples = np.asarray(audio, dtype=np.float32).reshape(-1)
        return self._vad.speech_timestamps(samples, probs=self.probabilities(samples))

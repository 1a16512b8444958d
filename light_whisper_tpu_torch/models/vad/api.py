"""FireRedVAD runtime on the card (counterpart of ``models/vad/api.py``).

Same surface the engine server calls: ``probabilities`` / ``warmup`` /
``speech_timestamps`` on 16 kHz float32 PCM. fbank, CMVN and the DFSMN run
on ``device``; segmentation runs on the host (``segmenter.speech_segments``).
Lengths are not padded to buckets. The reference's native C++ segmenter has
the same semantics as ``speech_segments`` and is not ported.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from light_whisper_tpu_torch.audio import fbank as kfb
from light_whisper_tpu_torch.audio.fbank import SAMPLE_RATE
from light_whisper_tpu_torch.formats import gguf
from light_whisper_tpu_torch.models.vad import dfsmn
from light_whisper_tpu_torch.models.vad.segmenter import SegmenterOptions, speech_segments

BUNDLED_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fireredvad.gguf")


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

"""FireRedVAD runtime on the card (counterpart of ``models/vad/api.py``).

Same surface the engine server calls: ``probabilities`` / ``warmup`` /
``speech_timestamps`` on 16 kHz float32 PCM. fbank, CMVN and the DFSMN run
on ``device``; segmentation runs on the host through the reference's
``segmenter`` (or its native C++ twin). Lengths are not padded to buckets.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

import light_whisper_tpu.models.vad as _reference_vad
from light_whisper_tpu.formats import gguf
from light_whisper_tpu.models.vad.segmenter import SegmenterOptions, speech_segments
from light_whisper_tpu_torch.audio import fbank as kfb
from light_whisper_tpu_torch.audio.fbank import SAMPLE_RATE
from light_whisper_tpu_torch.models.vad import dfsmn

BUNDLED_WEIGHTS = os.path.join(os.path.dirname(_reference_vad.__file__), "fireredvad.gguf")


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
        from light_whisper_tpu.native import binding

        if binding.available():  # native hysteresis segmenter (same semantics, C++)
            o = self.options
            pairs = binding.vad_segments(
                probs,
                len(samples),
                threshold=o.threshold,
                smooth_window=o.smooth_window_frames,
                min_speech_ms=o.min_speech_duration_ms,
                min_silence_ms=o.min_silence_duration_ms,
                pad_ms=o.speech_pad_ms,
            )
            return [{"start": s, "end": e} for s, e in pairs]
        return speech_segments(probs, len(samples), self.options)

"""FireRedVAD DFSMN frame classifier (counterpart of ``models/vad/dfsmn.py``).

Per-frame MLPs are [T, ·] × [·, ·] matmuls; each memory block's
lookback/lookahead taps form one depthwise 40-tap correlation. Frames at or
past ``valid_frames`` are zeroed before every memory block, which keeps the
zero-padded convolution semantics of the original graph when the caller pads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from light_whisper_tpu.models.vad.onnx_import import FILTER_TAPS, NUM_BLOCKS


def combined_filter(back: np.ndarray, ahead: np.ndarray) -> np.ndarray:
    """Merge lookback/lookahead taps into one [2*TAPS, C] depthwise kernel:
    position j sees frame t - 19 + j (lookback j <= 19, lookahead j >= 20)."""
    return np.concatenate([back.T, ahead.T], axis=0).astype(np.float32)


def _memory_block(x: torch.Tensor, filt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x: [T, C]; filt: [2*TAPS, C]; mask: [T, 1] validity."""
    x = x * mask
    xp = torch.nn.functional.pad(x.t()[None], (FILTER_TAPS - 1, FILTER_TAPS))  # [1, C, T+39]
    out = torch.nn.functional.conv1d(xp, filt.t()[:, None, :], groups=x.shape[1])[0].t()
    return x + out


def dfsmn_probs(params: Dict[str, torch.Tensor], feat: torch.Tensor, valid_frames: int) -> torch.Tensor:
    """Speech probability per frame. feat: [T, 80] CMVN-normalised fbank;
    frames >= ``valid_frames`` count as absent. Returns [T] f32."""
    relu = torch.relu
    mask = (torch.arange(feat.shape[0], device=feat.device) < valid_frames)[:, None].to(feat.dtype)
    h = relu(feat @ params["fc1.w"] + params["fc1.b"])
    h = relu(h @ params["fc2.w"] + params["fc2.b"])
    prev = _memory_block(h, params["fsmn1.filt"], mask)
    for i in range(NUM_BLOCKS):
        z = relu(prev @ params[f"blocks.{i}.fc1.w"] + params[f"blocks.{i}.fc1.b"])
        z = z @ params[f"blocks.{i}.fc2.w"]
        z = _memory_block(z, params[f"blocks.{i}.filt"], mask)
        prev = z + prev
    h = relu(prev @ params["dnn.w"] + params["dnn.b"])
    logit = h @ params["out.w"] + params["out.b"]
    return torch.sigmoid(logit[:, 0])


def prepare_params(flat: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Fold raw filters into combined kernels and move every leaf to ``device``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        if key.endswith(".back"):
            stem = key[: -len(".back")]
            value = combined_filter(flat[f"{stem}.back"], flat[f"{stem}.ahead"])
            key = f"{stem}.filt"
        elif key.endswith(".ahead"):
            continue
        out[key] = torch.as_tensor(np.asarray(value, dtype=np.float32), device=device)
    return out

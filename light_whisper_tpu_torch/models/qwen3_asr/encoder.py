"""AuT audio encoder (counterpart of ``models/qwen3_asr/encoder.py``).

128-mel log-mel → chunks of ``2·n_window`` frames → 3 × Conv2d(k=3, stride 2,
pad 1) + exact GELU over (mel, time) per chunk → channel-major flatten →
linear to d_model + sinusoid positions restarting at each chunk → pre-LN
transformer with block-diagonal attention over windows (tail-masked) →
ln_post → proj1 → GELU → proj2.

The three convolutions run in f32 through cuDNN with TF32 off
(``torch.backends.cudnn.flags(allow_tf32=False)``); plain f32 matmuls keep
PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 = False``. Every
Q8 linear goes through the Q8 kernel.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from light_whisper_tpu_torch.models.qwen3_asr.config import AudioEncoderConfig, conv_output_length
from light_whisper_tpu_torch.models.qwen3_asr.decoder import Replicated, layer_views, torch_dtype
from light_whisper_tpu_torch.ops.decode_attention import NEG_INF
from light_whisper_tpu_torch.ops.linear import apply_linear


def sinusoid_positions(length: int, channels: int, max_timescale: float = 10_000.0) -> np.ndarray:
    """Whisper-style sinusoid table: [length, channels] = [sin | cos]."""
    log_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_increment * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def _conv2d(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x: [N, Cin, H, W]; w: [Cout, Cin, 3, 3]; stride 2, pad 1, f32."""
    return F.conv2d(x.float(), p["w"].float(), p["b"].float(), stride=2, padding=1)


def _layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * p["w"].float() + p["b"].float()).to(x.dtype)


def _row_linear(p: Dict[str, torch.Tensor], x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel linear (o, fc2): the partial products are summed over
    the tensor-parallel ranks before the bias, which is added once."""
    out = tp.reduce(apply_linear({k: v for k, v in p.items() if k != "b"}, x))
    return out + p["b"].float() if "b" in p else out


def _windowed_attention(cfg: AudioEncoderConfig, layer: Dict, x: torch.Tensor, mask: torch.Tensor,
                        tp=Replicated) -> torch.Tensor:
    G, W, _ = x.shape
    H = cfg.head_count  # this rank's heads under tensor parallelism
    dtype = torch_dtype(cfg.compute_dtype)
    x = tp.enter(x)
    q, k, v = (apply_linear(layer[n], x).reshape(G, W, H, -1) for n in ("q", "k", "v"))
    hd = q.shape[-1]
    logits = torch.einsum("gqhd,gkhd->ghqk", q.to(dtype).float(), k.to(dtype).float()) * (hd ** -0.5)
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("ghqk,gkhd->gqhd", weights.to(dtype).float(), v.to(dtype).float()).to(x.dtype)
    return _row_linear(layer["o"], out.reshape(G, W, H * hd), tp).to(x.dtype)


def _encoder_layer(cfg: AudioEncoderConfig, layer: Dict, x: torch.Tensor, mask: torch.Tensor,
                   tp=Replicated) -> torch.Tensor:
    eps = cfg.layer_norm_epsilon
    h = _layer_norm(x, layer["attn_norm"], eps)
    x = x + _windowed_attention(cfg, layer, h, mask, tp)
    h = _layer_norm(x, layer["ffn_norm"], eps)
    h = _gelu(apply_linear(layer["fc1"], tp.enter(h))).to(x.dtype)
    return x + _row_linear(layer["fc2"], h, tp).to(x.dtype)


def encode_chunks_batch(
    cfg: AudioEncoderConfig,
    params: Dict,
    mel: torch.Tensor,  # [B, num_chunks * chunk_frames, mels] f32, zero-padded tails
    valid_tokens: Sequence[int],  # per stream: post-conv valid token count
    num_chunks: int,
    tp=Replicated,
) -> torch.Tensor:
    """[B, num_chunks * tokens_per_chunk, output_dim]; rows >= valid_tokens[b]
    are garbage and must be sliced off by the caller. Differentiable; the
    convolutions hold TF32 off only while they run forward, so a caller that
    takes gradients holds it off around the backward too (``parallel.train``
    does). ``tp``: the tensor-parallel seams (``decoder.forward_train``)."""
    B = mel.shape[0]
    chunk = cfg.chunk_frames
    tpc = cfg.tokens_per_chunk
    dtype = torch_dtype(cfg.compute_dtype)

    # HF orientation: the conv kernels see (H = mel, W = time)
    x = mel.reshape(B * num_chunks, chunk, cfg.num_mel_bins).transpose(1, 2)[:, None]  # [BC, 1, M, T]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        x = _gelu(_conv2d(x, params["conv1"]))
        x = _gelu(_conv2d(x, params["conv2"]))
        x = _gelu(_conv2d(x, params["conv3"]))
    # [BC, hidden, freq, tpc] -> [BC, tpc, hidden*freq] (channel-major features)
    BC, ch, f, t = x.shape
    x = x.permute(0, 3, 1, 2).reshape(BC, t, ch * f)
    x = apply_linear(params["conv_out"], x).to(dtype)  # [BC, tpc, D]
    x = x + params["pos_embd"][:tpc].to(dtype)[None]

    # group each stream's chunks into attention windows (never across streams)
    C = num_chunks
    wt = cfg.window_tokens
    chunks_per_group = max(1, wt // tpc)
    G = (C + chunks_per_group - 1) // chunks_per_group
    pad_chunks = G * chunks_per_group - C
    x = x.reshape(B, C, tpc, -1)
    x = F.pad(x, (0, 0, 0, 0, 0, pad_chunks))
    W = chunks_per_group * tpc
    x = x.reshape(B * G, W, x.shape[-1])

    token_idx = torch.arange(G * W, device=x.device).reshape(1, G, W)
    valid = torch.as_tensor(list(valid_tokens), device=x.device).reshape(B, 1, 1)
    mask = (token_idx < valid).reshape(B * G, W)

    for layer in layer_views(params["layers"]):
        x = _encoder_layer(cfg, layer, x, mask, tp)

    x = x.reshape(B, G * W, -1)[:, : C * tpc]
    x = _layer_norm(x, params["ln_post"], cfg.layer_norm_epsilon)
    x = _gelu(apply_linear(params["proj1"], x)).to(dtype)
    return apply_linear(params["proj2"], x).to(dtype)


def encode_chunks(cfg: AudioEncoderConfig, params: Dict, mel: torch.Tensor, valid_tokens: int, num_chunks: int,
                  tp=Replicated) -> torch.Tensor:
    """Single-stream :func:`encode_chunks_batch`: [num_chunks * tpc, output_dim]."""
    return encode_chunks_batch(cfg, params, mel[None], [valid_tokens], num_chunks, tp)[0]


def encode(cfg: AudioEncoderConfig, params: Dict, mel: torch.Tensor, tp=Replicated) -> Tuple[torch.Tensor, int]:
    """Pad ``mel`` ([frames, mels], or [B, frames, mels] with one frame count) to
    whole chunks, encode, and report the valid token count of ``frames``: every
    frame counts, a padded tail included."""
    batched = mel.dim() == 3
    mel = mel.float() if batched else mel.float()[None]
    frames = mel.shape[1]
    chunk = cfg.chunk_frames
    num_chunks = max(1, (frames + chunk - 1) // chunk)
    mel = F.pad(mel, (0, 0, 0, num_chunks * chunk - frames))
    full_chunks, tail = divmod(frames, chunk)
    valid = full_chunks * cfg.tokens_per_chunk + (conv_output_length(tail) if tail else 0)
    out = encode_chunks_batch(cfg, params, mel, [valid] * mel.shape[0], num_chunks, tp)
    return (out if batched else out[0]), valid

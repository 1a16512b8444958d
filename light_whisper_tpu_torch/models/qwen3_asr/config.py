"""Qwen3-ASR model configuration, read from GGUF metadata (the port's copy of
``light_whisper_tpu/models/qwen3_asr/config.py``, without the JAX ``dtype``
properties: the port maps ``compute_dtype`` with ``decoder.torch_dtype``).

Every hyperparameter comes from the GGUF header at load time, so one engine
serves both 0.6B and 1.7B artifacts, and tiny synthetic models in tests.

Architecture family (Qwen3-Omni "AuT" audio tower + Qwen3 dense LM):

- audio encoder: 128-mel log-mel → chunked 3×Conv2d(stride 2) downsampler
  (8× in time) → linear → sinusoidal positions (restarting per chunk) →
  pre-LayerNorm bidirectional transformer with block-diagonal attention over
  fixed windows → ln_post → proj1/gelu/proj2 into the LM embedding space.
- decoder: Qwen3 — RMSNorm, GQA attention with per-head q/k RMSNorm, NeoX
  RoPE, SwiGLU MLP, optional tied embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

ARCH = "qwen3asr"


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    num_mel_bins: int = 128
    d_model: int = 1280
    block_count: int = 32
    head_count: int = 20
    feed_forward_length: int = 5120
    downsample_hidden_size: int = 480
    output_dim: int = 1024  # == decoder embedding_length
    n_window: int = 50  # chunk = 2*n_window mel frames
    n_window_infer: int = 400  # attention window, in mel frames
    max_source_positions: int = 1500
    layer_norm_epsilon: float = 1e-5
    compute_dtype: str = "bfloat16"  # "float32" = precise fidelity mode

    @property
    def chunk_frames(self) -> int:
        return 2 * self.n_window

    @property
    def tokens_per_chunk(self) -> int:
        return conv_output_length(self.chunk_frames)

    @property
    def window_tokens(self) -> int:
        """Post-conv attention window (block-diagonal attention block size)."""
        return self.tokens_per_chunk * max(1, self.n_window_infer // self.chunk_frames)

    @property
    def freq_after_conv(self) -> int:
        f = self.num_mel_bins
        for _ in range(3):
            f = (f + 1) // 2
        return f


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 151_936
    embedding_length: int = 1024
    block_count: int = 28
    feed_forward_length: int = 3072
    head_count: int = 16
    head_count_kv: int = 8
    key_length: int = 128  # head_dim
    rms_epsilon: float = 1e-6
    rope_freq_base: float = 1_000_000.0
    context_length: int = 32_768
    tie_word_embeddings: bool = True
    compute_dtype: str = "bfloat16"  # "float32" = precise fidelity mode


@dataclasses.dataclass(frozen=True)
class Qwen3ASRConfig:
    audio: AudioEncoderConfig
    decoder: DecoderConfig
    audio_token_id: int = 151_676
    bos_token_id: int = 151_644  # <|im_start|>
    eos_token_id: int = 151_645  # <|im_end|>
    pad_token_id: int = 151_643

    def with_compute_dtype(self, dtype: str) -> "Qwen3ASRConfig":
        return dataclasses.replace(
            self,
            audio=dataclasses.replace(self.audio, compute_dtype=dtype),
            decoder=dataclasses.replace(self.decoder, compute_dtype=dtype),
        )


def conv_output_length(frames: int) -> int:
    """Length after the 3 stride-2 (k=3, pad=1) convs: ceil(x/2) three times."""
    for _ in range(3):
        frames = (frames + 1) // 2
    return frames


def _get(meta: Dict[str, Any], key: str, default):
    value = meta.get(f"{ARCH}.{key}")
    if value is None:
        return default
    return type(default)(value) if default is not None else value


def config_from_metadata(meta: Dict[str, Any]) -> Qwen3ASRConfig:
    arch = meta.get("general.architecture")
    if arch not in (ARCH, "qwen3-asr"):
        raise ValueError(f"unsupported architecture {arch!r}")

    dec = DecoderConfig(
        vocab_size=_get(meta, "vocab_size", DecoderConfig.vocab_size),
        embedding_length=_get(meta, "embedding_length", DecoderConfig.embedding_length),
        block_count=_get(meta, "block_count", DecoderConfig.block_count),
        feed_forward_length=_get(meta, "feed_forward_length", DecoderConfig.feed_forward_length),
        head_count=_get(meta, "attention.head_count", DecoderConfig.head_count),
        head_count_kv=_get(meta, "attention.head_count_kv", DecoderConfig.head_count_kv),
        key_length=_get(meta, "attention.key_length", DecoderConfig.key_length),
        rms_epsilon=_get(meta, "attention.layer_norm_rms_epsilon", DecoderConfig.rms_epsilon),
        rope_freq_base=_get(meta, "rope.freq_base", DecoderConfig.rope_freq_base),
        context_length=_get(meta, "context_length", DecoderConfig.context_length),
        tie_word_embeddings=bool(meta.get(f"{ARCH}.tie_word_embeddings", True)),
    )
    enc = AudioEncoderConfig(
        num_mel_bins=_get(meta, "audio.num_mel_bins", AudioEncoderConfig.num_mel_bins),
        d_model=_get(meta, "audio.d_model", AudioEncoderConfig.d_model),
        block_count=_get(meta, "audio.block_count", AudioEncoderConfig.block_count),
        head_count=_get(meta, "audio.head_count", AudioEncoderConfig.head_count),
        feed_forward_length=_get(
            meta, "audio.feed_forward_length", AudioEncoderConfig.feed_forward_length
        ),
        downsample_hidden_size=_get(
            meta, "audio.downsample_hidden_size", AudioEncoderConfig.downsample_hidden_size
        ),
        output_dim=_get(meta, "audio.output_dim", dec.embedding_length),
        n_window=_get(meta, "audio.n_window", AudioEncoderConfig.n_window),
        n_window_infer=_get(meta, "audio.n_window_infer", AudioEncoderConfig.n_window_infer),
        max_source_positions=_get(
            meta, "audio.max_source_positions", AudioEncoderConfig.max_source_positions
        ),
        layer_norm_epsilon=_get(
            meta, "audio.layer_norm_epsilon", AudioEncoderConfig.layer_norm_epsilon
        ),
    )
    return Qwen3ASRConfig(
        audio=enc,
        decoder=dec,
        audio_token_id=_get(meta, "audio_token_id", Qwen3ASRConfig.audio_token_id),
        bos_token_id=_get(meta, "bos_token_id", Qwen3ASRConfig.bos_token_id),
        eos_token_id=_get(meta, "eos_token_id", Qwen3ASRConfig.eos_token_id),
        pad_token_id=_get(meta, "pad_token_id", Qwen3ASRConfig.pad_token_id),
    )


def metadata_from_config(cfg: Qwen3ASRConfig, name: str = "qwen3-asr") -> Dict[str, Any]:
    """Inverse of :func:`config_from_metadata` (used by export/tests)."""
    return {
        "general.architecture": ARCH,
        "general.name": name,
        f"{ARCH}.vocab_size": cfg.decoder.vocab_size,
        f"{ARCH}.embedding_length": cfg.decoder.embedding_length,
        f"{ARCH}.block_count": cfg.decoder.block_count,
        f"{ARCH}.feed_forward_length": cfg.decoder.feed_forward_length,
        f"{ARCH}.attention.head_count": cfg.decoder.head_count,
        f"{ARCH}.attention.head_count_kv": cfg.decoder.head_count_kv,
        f"{ARCH}.attention.key_length": cfg.decoder.key_length,
        f"{ARCH}.attention.layer_norm_rms_epsilon": cfg.decoder.rms_epsilon,
        f"{ARCH}.rope.freq_base": cfg.decoder.rope_freq_base,
        f"{ARCH}.context_length": cfg.decoder.context_length,
        f"{ARCH}.tie_word_embeddings": cfg.decoder.tie_word_embeddings,
        f"{ARCH}.audio.num_mel_bins": cfg.audio.num_mel_bins,
        f"{ARCH}.audio.d_model": cfg.audio.d_model,
        f"{ARCH}.audio.block_count": cfg.audio.block_count,
        f"{ARCH}.audio.head_count": cfg.audio.head_count,
        f"{ARCH}.audio.feed_forward_length": cfg.audio.feed_forward_length,
        f"{ARCH}.audio.downsample_hidden_size": cfg.audio.downsample_hidden_size,
        f"{ARCH}.audio.output_dim": cfg.audio.output_dim,
        f"{ARCH}.audio.n_window": cfg.audio.n_window,
        f"{ARCH}.audio.n_window_infer": cfg.audio.n_window_infer,
        f"{ARCH}.audio.max_source_positions": cfg.audio.max_source_positions,
        f"{ARCH}.audio.layer_norm_epsilon": cfg.audio.layer_norm_epsilon,
        f"{ARCH}.audio_token_id": cfg.audio_token_id,
        f"{ARCH}.bos_token_id": cfg.bos_token_id,
        f"{ARCH}.eos_token_id": cfg.eos_token_id,
        f"{ARCH}.pad_token_id": cfg.pad_token_id,
    }

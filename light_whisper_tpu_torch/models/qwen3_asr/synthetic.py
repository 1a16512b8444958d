"""Qwen3-ASR artifacts with random weights from a seed, written through the
port's own export: the models that ``chip_smoke.py`` serves and that the
multi-device dry run (``parallel.dryrun``) shards, with no file from outside
the repository."""

from __future__ import annotations

import os

import numpy as np

from light_whisper_tpu_torch.models.qwen3_asr.config import AudioEncoderConfig, DecoderConfig, Qwen3ASRConfig
from light_whisper_tpu_torch.models.qwen3_asr.export import write_model as export
from light_whisper_tpu_torch.models.qwen3_asr.tokenizer import byte_to_unicode


def qwen3_asr_06b_config() -> Qwen3ASRConfig:
    """Qwen3-ASR 0.6B: a Qwen3-0.6B decoder and the AuT audio encoder."""
    dec = DecoderConfig(vocab_size=151_936, embedding_length=1024, block_count=28, feed_forward_length=3072,
                        head_count=16, head_count_kv=8, key_length=128, context_length=32_768)
    enc = AudioEncoderConfig(num_mel_bins=128, d_model=896, block_count=18, head_count=14,
                             feed_forward_length=3584, downsample_hidden_size=480,
                             output_dim=dec.embedding_length, n_window=50, n_window_infer=400,
                             max_source_positions=3000)
    return Qwen3ASRConfig(audio=enc, decoder=dec, audio_token_id=151_676)


def random_tensors(cfg, seed: int):
    """Every tensor of a Qwen3-ASR artifact, (out, in)-oriented, random from
    ``seed``: matrices N(0, 1/in), embeddings N(0, 0.05^2), unit norms, zero
    biases. The draw order is part of the artifact: a seed names its bytes."""
    rng = np.random.default_rng(seed)
    d, a = cfg.decoder, cfg.audio

    def mat(out_f, in_f, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(in_f))
        return (rng.standard_normal((out_f, in_f)) * scale).astype(np.float32)

    tensors = {
        "token_embd.weight": mat(d.vocab_size, d.embedding_length, 0.05),
        "output_norm.weight": np.ones(d.embedding_length, np.float32)
        + rng.standard_normal(d.embedding_length).astype(np.float32) * 0.02,
    }
    for i in range(d.block_count):
        p = f"blk.{i}."
        qdim = d.head_count * d.key_length
        kvdim = d.head_count_kv * d.key_length
        tensors[p + "attn_norm.weight"] = np.ones(d.embedding_length, np.float32)
        tensors[p + "attn_q.weight"] = mat(qdim, d.embedding_length)
        tensors[p + "attn_k.weight"] = mat(kvdim, d.embedding_length)
        tensors[p + "attn_v.weight"] = mat(kvdim, d.embedding_length)
        tensors[p + "attn_output.weight"] = mat(d.embedding_length, qdim)
        tensors[p + "attn_q_norm.weight"] = np.ones(d.key_length, np.float32)
        tensors[p + "attn_k_norm.weight"] = np.ones(d.key_length, np.float32)
        tensors[p + "ffn_norm.weight"] = np.ones(d.embedding_length, np.float32)
        tensors[p + "ffn_gate.weight"] = mat(d.feed_forward_length, d.embedding_length)
        tensors[p + "ffn_up.weight"] = mat(d.feed_forward_length, d.embedding_length)
        tensors[p + "ffn_down.weight"] = mat(d.embedding_length, d.feed_forward_length)

    h = a.downsample_hidden_size
    tensors["aenc.conv1.weight"] = (rng.standard_normal((h, 1, 3, 3)) * 0.2).astype(np.float32)
    tensors["aenc.conv1.bias"] = np.zeros(h, np.float32)
    tensors["aenc.conv2.weight"] = (rng.standard_normal((h, h, 3, 3)) * (0.2 / np.sqrt(h))).astype(np.float32)
    tensors["aenc.conv2.bias"] = np.zeros(h, np.float32)
    tensors["aenc.conv3.weight"] = (rng.standard_normal((h, h, 3, 3)) * (0.2 / np.sqrt(h))).astype(np.float32)
    tensors["aenc.conv3.bias"] = np.zeros(h, np.float32)
    tensors["aenc.conv_out.weight"] = mat(a.d_model, h * a.freq_after_conv)
    for i in range(a.block_count):
        p = f"aenc.blk.{i}."
        tensors[p + "attn_norm.weight"] = np.ones(a.d_model, np.float32)
        tensors[p + "attn_norm.bias"] = np.zeros(a.d_model, np.float32)
        for name in ("attn_q", "attn_k", "attn_v", "attn_output"):
            tensors[p + name + ".weight"] = mat(a.d_model, a.d_model)
            tensors[p + name + ".bias"] = np.zeros(a.d_model, np.float32)
        tensors[p + "ffn_norm.weight"] = np.ones(a.d_model, np.float32)
        tensors[p + "ffn_norm.bias"] = np.zeros(a.d_model, np.float32)
        tensors[p + "ffn_up.weight"] = mat(a.feed_forward_length, a.d_model)
        tensors[p + "ffn_up.bias"] = np.zeros(a.feed_forward_length, np.float32)
        tensors[p + "ffn_down.weight"] = mat(a.d_model, a.feed_forward_length)
        tensors[p + "ffn_down.bias"] = np.zeros(a.d_model, np.float32)
    tensors["aenc.ln_post.weight"] = np.ones(a.d_model, np.float32)
    tensors["aenc.ln_post.bias"] = np.zeros(a.d_model, np.float32)
    tensors["aenc.proj1.weight"] = mat(a.d_model, a.d_model)
    tensors["aenc.proj1.bias"] = np.zeros(a.d_model, np.float32)
    tensors["aenc.proj2.weight"] = mat(a.output_dim, a.d_model)
    tensors["aenc.proj2.bias"] = np.zeros(a.output_dim, np.float32)
    return tensors


def vocab(cfg):
    """Byte tokens, filler pieces, and the specials at the config's ids."""
    b2u = byte_to_unicode()
    n = cfg.decoder.vocab_size
    tokens = [b2u[b] for b in range(256)] + [f"tok{i}" for i in range(256, n)]
    types = [1] * n
    for tid, text in ((cfg.pad_token_id, "<|endoftext|>"), (cfg.bos_token_id, "<|im_start|>"),
                      (cfg.eos_token_id, "<|im_end|>"), (cfg.audio_token_id, "<|audio_pad|>")):
        tokens[tid] = text
        types[tid] = 3
    return tokens, types


TEMPLATE = "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n"


def write_model(path: str, cfg, seed: int, template: str = TEMPLATE, quantize: bool = True) -> None:
    """A GGUF of ``random_tensors(cfg, seed)`` through the port's export:
    Q8_0, or dense with ``quantize=False``."""
    tokens, types = vocab(cfg)
    meta = {
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": types,
        "tokenizer.ggml.merges": [],
        "tokenizer.chat_template": template,
    }
    tmp = path + ".tmp"
    export(tmp, cfg, random_tensors(cfg, seed), meta, quantize=quantize)
    os.replace(tmp, path)

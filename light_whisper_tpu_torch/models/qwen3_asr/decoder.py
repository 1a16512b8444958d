"""Qwen3 decoder, single stream (counterpart of ``models/qwen3_asr/decoder.py``).

GQA with per-head q/k RMSNorm, half-split ("rotate_half") RoPE and SwiGLU.
Parameters are the reference's tree as a dict of tensors: layer weights are
stacked on a leading axis and a Python loop walks the layers; Q8 projections
go through the layer-indexed kernels (``q[idx]`` is a view, nothing is
copied). The KV cache is head-major ``[L, Hkv, C, hd]`` and is updated in
place (the JAX package donates and rebuilds it).

Routing follows the reference's fused-decode flow (``_layer_forward_stacked``):

- T <= 8 with Q8 weights: the rms-norm prologue and the residual epilogue run
  inside the Q8 kernel (``q8_matmul_stacked_fused``);
- T > 8: the unfused stacked kernel, with ``rms_norm`` and the residual add in
  torch;
- attention of 1 <= T <= 64 bf16 rows goes through the decode-attention
  kernel; longer prompts (and f32 precise compute) take the plain masked
  softmax. The reference's chunked attention for caches of 8192 and more is
  not ported yet.

Numerics match the reference's unfused path, which its fused kernels are
built to reproduce bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from light_whisper_tpu.models.qwen3_asr.config import DecoderConfig
from light_whisper_tpu_torch.ops.decode_attention import (
    MAX_ROWS as ATTENTION_KERNEL_MAX_ROWS,
    NEG_INF,
    attention_plain,
    decode_attention,
)
from light_whisper_tpu_torch.ops.linear import apply_linear, dense_matmul
from light_whisper_tpu_torch.ops.q8_matmul import (
    FUSED_MAX_ROWS,
    Q8_0_BLOCK,
    q8_matmul_stacked,
    q8_matmul_stacked_fused,
    rms_norm,
)

_PROJ_NAMES = ("qkv", "o", "gateup", "down")


def torch_dtype(compute_dtype: str) -> torch.dtype:
    """The config's ``compute_dtype`` string as a torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[compute_dtype]


@dataclasses.dataclass
class KVCache:
    """Per-layer key/value buffers and the fill level (a host int)."""

    k: torch.Tensor  # [L, Hkv, C, hd]
    v: torch.Tensor
    pos: int = 0


def init_cache(cfg: DecoderConfig, capacity: int, dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (cfg.block_count, cfg.head_count_kv, capacity, cfg.key_length)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=0,
    )


def rope_tables(positions: torch.Tensor, head_dim: int, base: float) -> Tuple[torch.Tensor, torch.Tensor]:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(base, dtype=torch.float32, device=positions.device), exponent)
    angles = positions.float()[:, None] * inv_freq[None, :]  # [T, hd/2]
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1)
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [T, H, hd]; cos/sin: [T, hd] (f32 math, HF rotate_half)."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    out = xf * cos[:, None, :] + rotated * sin[:, None, :]
    return out.to(x.dtype)


def _split_qkv(cfg: DecoderConfig, qkv: torch.Tensor, T: int):
    hd = cfg.key_length
    qdim = cfg.head_count * hd
    kvdim = cfg.head_count_kv * hd
    q = qkv[:, :qdim].reshape(T, cfg.head_count, hd)
    k = qkv[:, qdim : qdim + kvdim].reshape(T, cfg.head_count_kv, hd)
    v = qkv[:, qdim + kvdim :].reshape(T, cfg.head_count_kv, hd)
    return q, k, v


def _attention(cfg: DecoderConfig, q: torch.Tensor, cache: KVCache, idx: int, start: int) -> torch.Tensor:
    T = q.shape[0]
    dtype = torch_dtype(cfg.compute_dtype)
    if dtype == torch.bfloat16 and 1 <= T <= ATTENTION_KERNEL_MAX_ROWS:
        return decode_attention(q, cache.k, cache.v, start, idx)
    return attention_plain(q, cache.k[idx], cache.v[idx], start, dtype)


def _layer_forward(
    cfg: DecoderConfig,
    layers: Dict,
    idx: int,
    x: torch.Tensor,  # [T, D]
    cache: KVCache,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> torch.Tensor:
    T = x.shape[0]
    eps = cfg.rms_epsilon
    quantized = all("q" in layers[name] for name in _PROJ_NAMES)
    fused = quantized and T <= FUSED_MAX_ROWS

    def proj(name, h):
        p = layers[name]
        if "q" in p:
            return q8_matmul_stacked(h, p["q"], p["s"], idx)
        return dense_matmul(h, p["w"][idx])

    def proj_norm(name, h, norm_w):
        if not fused:
            return proj(name, rms_norm(h, norm_w, eps))
        p = layers[name]
        return q8_matmul_stacked_fused(h, p["q"], p["s"], idx, norm_w=norm_w, eps=eps)

    def proj_residual(name, h, residual):
        if not fused:
            return residual + proj(name, h).to(residual.dtype)
        p = layers[name]
        return q8_matmul_stacked_fused(h, p["q"], p["s"], idx, residual=residual).to(residual.dtype)

    q, k, v = _split_qkv(cfg, proj_norm("qkv", x, layers["attn_norm"][idx]), T)
    q = rms_norm(q, layers["q_norm"][idx], eps)
    k = rms_norm(k, layers["k_norm"][idx], eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    pos = cache.pos
    cache.k[idx, :, pos : pos + T] = k.transpose(0, 1).to(cache.k.dtype)
    cache.v[idx, :, pos : pos + T] = v.transpose(0, 1).to(cache.v.dtype)

    attn = _attention(cfg, q, cache, idx, pos)
    x = proj_residual("o", attn.reshape(T, -1), x)
    gateup = proj_norm("gateup", x, layers["ffn_norm"][idx])
    gate, up = torch.chunk(gateup, 2, dim=-1)
    return proj_residual("down", (torch.nn.functional.silu(gate) * up).to(x.dtype), x)


def forward(cfg: DecoderConfig, params: Dict, embeds: torch.Tensor, cache: KVCache) -> torch.Tensor:
    """Run all layers over T new positions; returns hidden states [T, D] and
    advances ``cache`` (written in place) by T."""
    T = embeds.shape[0]
    positions = cache.pos + torch.arange(T, device=embeds.device)
    cos, sin = rope_tables(positions, cfg.key_length, cfg.rope_freq_base)
    layers = params["layers"]
    x = embeds
    for idx in range(cfg.block_count):
        x = _layer_forward(cfg, layers, idx, x, cache, cos, sin)
    cache.pos += T
    return rms_norm(x, params["final_norm"], cfg.rms_epsilon)


def logits_for(cfg: DecoderConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    head = params.get("lm_head")
    embed = params["embed"]
    if head is not None:
        logits = apply_linear(head, hidden)
    elif "q" in embed:
        # the tied Q8_0 embedding doubles as the output head ([V, D] = [out, in])
        logits = apply_linear(embed, hidden)
    else:
        dtype = torch_dtype(cfg.compute_dtype)
        logits = torch.matmul(hidden.to(dtype).float(), embed["w"].to(dtype).float().t())
    if logits.shape[-1] > cfg.vocab_size:
        # embedding rows are padded; padded slots must never win the argmax
        logits[..., cfg.vocab_size :] = NEG_INF
    return logits


def embed_tokens(params: Dict, ids: torch.Tensor) -> torch.Tensor:
    embed = params["embed"]
    if "q" in embed:
        rows_q = embed["q"][ids].to(torch.bfloat16)
        rows_s = embed["s"][ids].to(torch.bfloat16).repeat_interleave(Q8_0_BLOCK, dim=-1)
        return rows_q * rows_s
    return embed["w"][ids]


def decode_greedy(
    cfg: DecoderConfig,
    params: Dict,
    first_token: torch.Tensor,  # int scalar on the device: argmax after prefill
    cache: KVCache,
    eos_token_id: int,
    max_new_tokens: int,
    step_times: Optional[List[float]] = None,
) -> List[int]:
    """Greedy decode, one step per token with the argmax on the device.

    Returns the generated ids, EOS excluded, at most ``max_new_tokens``
    (the reference's on-device loop records the same ids; its final step,
    whose token is never recorded, is skipped). ``step_times`` collects the
    host wall of each step, synchronised by the EOS check."""
    generated: List[int] = []
    token = first_token.reshape(1)
    token_id = int(token.item())
    while token_id != eos_token_id and len(generated) < max_new_tokens:
        generated.append(token_id)
        if len(generated) == max_new_tokens:
            break
        t0 = time.perf_counter()
        hidden = forward(cfg, params, embed_tokens(params, token), cache)
        token = torch.argmax(logits_for(cfg, params, hidden[-1:])[-1]).reshape(1)
        token_id = int(token.item())
        if step_times is not None:
            step_times.append(time.perf_counter() - t0)
    return generated

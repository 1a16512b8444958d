"""Qwen3 decoder (counterpart of ``models/qwen3_asr/decoder.py``).

GQA with per-head q/k RMSNorm, half-split ("rotate_half") RoPE and SwiGLU.
Parameters are the reference's tree as a dict of tensors: layer weights are
stacked on a leading axis and a Python loop walks the layers; Q8 projections
go through the layer-indexed kernels (``q[idx]`` is a view, nothing is
copied). The KV cache is head-major ``[L, Hkv, C, hd]`` (one stream) or
``[B, L, Hkv, C, hd]`` (B streams, the layout of the reference's
``vmap(init_cache)``) and is updated in place (the JAX package donates and
rebuilds it).

Three forwards share one layer body (:func:`_layer_forward_rows`), which
differs only in how the new K/V are written and attended:

- :func:`forward`: T new positions of one stream;
- :func:`forward_decode_batch`: one new position for each of B streams, the
  streams on the matmul row axis (T = B), each attending its own cache up to
  its own position (the batched decode-attention kernel);
- :func:`forward_prefill_batch`: T new positions for each of B streams, rows
  ``[B·T, D]`` through the Q8 kernels, attention per stream.

Routing follows the reference's fused-decode flow (``_layer_forward_stacked``):

- up to 8 rows with Q8 weights: the rms-norm prologue and the residual
  epilogue run inside the Q8 kernel (``q8_matmul_stacked_fused``);
- more rows: the unfused stacked kernel, with ``rms_norm`` and the residual
  add in torch;
- attention (:func:`_attention_route`, the reference's ``_attention``):
  1 <= T <= 64 bf16 rows go through the decode-attention kernel (stacked for
  one stream, unstacked per stream in the batched prefill); more rows against
  a cache of 8192 slots or more (a multiple of 1024) take an online softmax
  over key blocks, as the reference does there: the flash-prefill kernel for
  bf16 on the card, :func:`attention_chunked` otherwise (the CPU, or f32
  precise compute); everything else takes the plain masked softmax, which
  holds ``[Hkv, G, T, C]`` f32 logits. The reference's ``LWT_FLASH_PREFILL``
  opt-in exists for its TPU compiler and is not ported;
- the FFN half: with ``LWT_FUSED_FFN`` set (read once a :func:`forward` call,
  as the reference's ``_use_fused_ffn``), the single-stream forward sends up
  to 8 rows with Q8 weights through the one-launch ``fused_ffn_step``, as the
  reference's ``_layer_forward_stacked`` does; the batched forwards never
  take it, as the reference's ``_layer_forward_batch`` does not.

The greedy loops step with :func:`decode_step` (the B=1 loop on a 1-stream
view of its cache, :meth:`KVCache.as_batch`): the batched decode forward at
device positions, so that on the card a loop captures its step once as a
CUDA graph and replays it for every token (``step_graph``, where
:func:`graphs_engage`; under a mesh and in f32 compute the same step runs
eagerly). With ``LWT_FUSED_FFN`` set and no mesh the B=1 loop keeps
:func:`forward` at the host position, eager: the one-launch FFN half is a
single-stream route.

Under a tensor-parallel mesh (``tp``, a ``parallel.sharding.TensorParallel``;
``Qwen3ASRModel(mesh=)``) ``cfg`` holds this rank's head and FFN counts and
``params`` its shard. The route is then one at every ``tp``, 1 included:
qkv and gate/up keep the rms-norm prologue (their input is replicated); o
and down never take the residual epilogue, which would add the residual on
every rank: their f32 partial is summed over the ranks (``tp.reduce``), then
added to the residual in bf16, the reference's unfused rounding; and the
fused FFN stays off, as the reference's does under a mesh (it runs only on
the stacked-kernel path, which needs the scales a mesh skips).

Numerics match the reference's unfused path, which its fused projection
kernels are built to reproduce bit for bit. The fused FFN adds the residual
once in f32 (the unfused half rounds twice in bf16), so it is off by default,
as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from light_whisper_tpu_torch.models.qwen3_asr.config import DecoderConfig
from light_whisper_tpu_torch.ops.decode_attention import (
    MAX_ROWS as ATTENTION_KERNEL_MAX_ROWS,
    NEG_INF,
    attention_plain,
    decode_attention,
    decode_attention_batched,
    decode_attention_batched_plain,
    decode_attention_unstacked,
)
from light_whisper_tpu_torch.ops.flash_prefill import flash_prefill, flash_prefill_plain
from light_whisper_tpu_torch.ops.fused_ffn import fused_ffn_step
from light_whisper_tpu_torch.ops.linear import apply_linear, dense_matmul
from light_whisper_tpu_torch.ops.q8_matmul import (
    FUSED_MAX_ROWS,
    Q8_0_BLOCK,
    q8_matmul_stacked,
    q8_matmul_stacked_fused,
    rms_norm,
)
from light_whisper_tpu_torch.models.qwen3_asr import step_graph
from light_whisper_tpu_torch.runtime import tracing

_PROJ_NAMES = ("qkv", "o", "gateup", "down")
# From this capacity on, prefill attention runs an online softmax over key
# blocks: the one-shot softmax would hold [Hkv, G, T, C] f32 logits (2.1 GB a
# layer at T = 3,968, C = 8192 and 0.6B heads).
CHUNKED_PREFILL_MIN_CAPACITY = 8192
PREFILL_KEY_CHUNK = 1024  # the reference's _attention_chunked key chunk


def torch_dtype(compute_dtype: str) -> torch.dtype:
    """The config's ``compute_dtype`` string as a torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[compute_dtype]


class Replicated:
    """The tensor-parallel seams of a layer when every weight is whole: both
    are the identity. ``parallel.sharding.TensorParallel`` is the sharded
    counterpart, where ``enter`` opens a column-parallel block and ``reduce``
    sums a row-parallel block's partial outputs over the ranks."""

    @staticmethod
    def enter(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def reduce(x: torch.Tensor) -> torch.Tensor:
        return x


@dataclasses.dataclass
class KVCache:
    """Per-layer key/value buffers and the fill level (a host int)."""

    k: torch.Tensor  # [L, Hkv, C, hd]
    v: torch.Tensor
    pos: int = 0

    def as_batch(self) -> "BatchKVCache":
        """This cache as one stream of a :class:`BatchKVCache`: ``[1, L, Hkv, C,
        hd]`` views of its buffers (nothing is copied) at its position."""
        view = BatchKVCache(k=self.k.unsqueeze(0), v=self.v.unsqueeze(0), pos=torch.zeros(0), pos_host=[])
        view.set_positions([self.pos])
        return view


def init_cache(cfg: DecoderConfig, capacity: int, dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (cfg.block_count, cfg.head_count_kv, capacity, cfg.key_length)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=0,
    )


@dataclasses.dataclass
class BatchKVCache:
    """Per-stream buffers of B streams and their fill levels, kept twice: on
    the device (read by the kernels, no host sync) and on the host (bounds
    checks and prefill starts, no device read)."""

    k: torch.Tensor  # [B, L, Hkv, C, hd]
    v: torch.Tensor
    pos: torch.Tensor  # int32 [B] on the cache's device
    pos_host: List[int]

    def set_positions(self, positions: Sequence[int]) -> None:
        self.pos_host = [int(p) for p in positions]
        self.pos = torch.tensor(self.pos_host, dtype=torch.int32, device=self.k.device)

    def advance(self, n: int) -> None:
        self.pos += n
        self.pos_host = [p + n for p in self.pos_host]


def init_cache_batch(cfg: DecoderConfig, batch: int, capacity: int, dtype=torch.bfloat16,
                     device="cpu") -> BatchKVCache:
    shape = (batch, cfg.block_count, cfg.head_count_kv, capacity, cfg.key_length)
    cache = BatchKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                         v=torch.zeros(shape, dtype=dtype, device=device),
                         pos=torch.zeros(0), pos_host=[])
    cache.set_positions([0] * batch)
    return cache


def rope_tables(positions: torch.Tensor, head_dim: int, base: float) -> Tuple[torch.Tensor, torch.Tensor]:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    # a Python base: a device tensor of it would be an upload, and a sync, every forward
    inv_freq = 1.0 / torch.pow(float(base), exponent)
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


def attention_chunked(
    q: torch.Tensor,  # [T, Hq, hd]
    k_layer: torch.Tensor,  # [Hkv, C, hd]
    v_layer: torch.Tensor,
    start: int,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The reference's ``_attention_chunked``: the online softmax of
    :func:`flash_prefill_plain` over key chunks of 1024, ``dtype`` operands
    (bf16, or f32 in precise mode). Returns f32 ``[T, Hq, hd]``."""
    return flash_prefill_plain(q, k_layer, v_layer, start, block_c=PREFILL_KEY_CHUNK, dtype=dtype)


def _attention_route(dtype: torch.dtype, T: int, capacity: int, device_type: str) -> str:
    """Which attention serves T query rows against a cache of ``capacity``
    (the reference's ``_attention``, without its TPU gates)."""
    if dtype == torch.bfloat16 and 1 <= T <= ATTENTION_KERNEL_MAX_ROWS:
        return "decode_attention"
    if T > 1 and capacity >= CHUNKED_PREFILL_MIN_CAPACITY and capacity % PREFILL_KEY_CHUNK == 0:
        return "flash_prefill" if dtype == torch.bfloat16 and device_type == "cuda" else "attention_chunked"
    return "attention_plain"


def _attend_rows(route: str, dtype: torch.dtype, q: torch.Tensor, k_layer: torch.Tensor,
                 v_layer: torch.Tensor, start: int) -> torch.Tensor:
    """Attention of ``q`` against one layer's ``[Hkv, C, hd]`` cache on every
    route of :func:`_attention_route` but the decode-attention kernel."""
    if route == "flash_prefill":
        return flash_prefill(q, k_layer, v_layer, start)
    if route == "attention_chunked":
        return attention_chunked(q, k_layer, v_layer, start, dtype)
    return attention_plain(q, k_layer, v_layer, start, dtype)


def _attention(cfg: DecoderConfig, q: torch.Tensor, cache: KVCache, idx: int, start: int) -> torch.Tensor:
    dtype = torch_dtype(cfg.compute_dtype)
    route = _attention_route(dtype, q.shape[0], cache.k.shape[2], q.device.type)
    if route == "decode_attention":
        return decode_attention(q, cache.k, cache.v, start, idx)
    return _attend_rows(route, dtype, q, cache.k[idx], cache.v[idx], start)


def _attention_unstacked(cfg: DecoderConfig, q: torch.Tensor, k_layer: torch.Tensor,
                         v_layer: torch.Tensor, start: int) -> torch.Tensor:
    """:func:`_attention` on one layer's ``[Hkv, C, hd]`` cache (the reference's
    ``_attention``, as the batched prefill calls it for each stream)."""
    dtype = torch_dtype(cfg.compute_dtype)
    route = _attention_route(dtype, q.shape[0], k_layer.shape[1], q.device.type)
    if route == "decode_attention":
        return decode_attention_unstacked(q, k_layer, v_layer, start)
    return _attend_rows(route, dtype, q, k_layer, v_layer, start)


def _attention_decode_batch(cfg: DecoderConfig, q: torch.Tensor, cache: BatchKVCache, idx: int) -> torch.Tensor:
    """Per-stream decode attention: row ``b`` of ``q [B, Hq, hd]`` attends to
    its own cache up to ``pos[b]`` (its just-written slot included)."""
    dtype = torch_dtype(cfg.compute_dtype)
    if dtype == torch.bfloat16:
        return decode_attention_batched(q, cache.k, cache.v, cache.pos, idx, cache.pos_host)
    return decode_attention_batched_plain(q, cache.k, cache.v, cache.pos, idx, dtype)


def _use_fused_ffn() -> bool:
    """``LWT_FUSED_FFN`` as the reference reads it: off unless set to
    something other than ``""`` or ``"0"``."""
    return os.environ.get("LWT_FUSED_FFN", "0") not in ("", "0")


def _fused_ffn_half(cfg: DecoderConfig, layers: Dict, idx: int, x: torch.Tensor) -> torch.Tensor:
    """The FFN half of a layer (norm → gate/up → silu·mul → down → residual) in
    one ``fused_ffn_step`` launch."""
    gu, dn = layers["gateup"], layers["down"]
    return fused_ffn_step(x, layers["ffn_norm"][idx], gu["q"], gu["s"], dn["q"], dn["s"], idx,
                          cfg.rms_epsilon).to(x.dtype)


def _layer_forward_rows(
    cfg: DecoderConfig,
    layers: Dict,
    idx: int,
    x: torch.Tensor,  # [R, D]
    cos: torch.Tensor,  # [R, hd]
    sin: torch.Tensor,
    attend: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    fused_ffn: bool = False,
    tp=Replicated,
) -> torch.Tensor:
    """One layer over R rows. ``attend(q [R, Hq, hd], k, v [R, Hkv, hd])`` writes
    the new K/V into its cache and returns the attention ``[R, Hq, hd]``.
    ``fused_ffn`` sends the FFN half of up to 8 Q8 rows through
    :func:`_fused_ffn_half`. ``tp``: a mesh's seams, which take the mesh's
    route (the module docstring) at every ``tp``, 1 included; ``Replicated``
    without a mesh. Nothing here takes a gradient, so the column-parallel
    blocks need no ``enter``."""
    meshed = tp is not Replicated
    R = x.shape[0]
    eps = cfg.rms_epsilon
    quantized = all("q" in layers[name] for name in _PROJ_NAMES)
    fused = quantized and R <= FUSED_MAX_ROWS

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
        if meshed:  # row-parallel: the ranks' f32 partials summed, then the residual once
            return residual + tp.reduce(proj(name, h)).to(residual.dtype)
        if not fused:
            return residual + proj(name, h).to(residual.dtype)
        p = layers[name]
        return q8_matmul_stacked_fused(h, p["q"], p["s"], idx, residual=residual).to(residual.dtype)

    q, k, v = _split_qkv(cfg, proj_norm("qkv", x, layers["attn_norm"][idx]), R)
    q = rms_norm(q, layers["q_norm"][idx], eps)
    k = rms_norm(k, layers["k_norm"][idx], eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    attn = attend(q, k, v)
    x = proj_residual("o", attn.reshape(R, -1), x)
    if fused and fused_ffn and not meshed:
        return _fused_ffn_half(cfg, layers, idx, x)
    gateup = proj_norm("gateup", x, layers["ffn_norm"][idx])
    gate, up = torch.chunk(gateup, 2, dim=-1)
    return proj_residual("down", (torch.nn.functional.silu(gate) * up).to(x.dtype), x)


def _layer_forward(
    cfg: DecoderConfig,
    layers: Dict,
    idx: int,
    x: torch.Tensor,  # [T, D]
    cache: KVCache,
    cos: torch.Tensor,
    sin: torch.Tensor,
    fused_ffn: bool = False,
    tp=Replicated,
) -> torch.Tensor:
    def attend(q, k, v):
        pos, T = cache.pos, q.shape[0]
        cache.k[idx, :, pos : pos + T] = k.transpose(0, 1).to(cache.k.dtype)
        cache.v[idx, :, pos : pos + T] = v.transpose(0, 1).to(cache.v.dtype)
        return _attention(cfg, q, cache, idx, pos)

    return _layer_forward_rows(cfg, layers, idx, x, cos, sin, attend, fused_ffn, tp)


def _layer_forward_batch(
    cfg: DecoderConfig,
    layers: Dict,
    idx: int,
    x: torch.Tensor,  # [B, D]: one new token per stream
    cache: BatchKVCache,
    cos: torch.Tensor,  # [B, hd]: per-stream rope tables
    sin: torch.Tensor,
    streams: torch.Tensor,  # arange(B), int64 on the device
    pos: torch.Tensor,  # cache.pos as int64
    tp=Replicated,
) -> torch.Tensor:
    """One layer over B single-token streams: the projections see T = B rows
    (one weight read for the batch); the cache write and attention are per
    stream, each at its own position."""

    def attend(q, k, v):
        # one indexed write for the batch: stream b's row lands at pos[b]
        cache.k[:, idx][streams, :, pos] = k.to(cache.k.dtype)
        cache.v[:, idx][streams, :, pos] = v.to(cache.v.dtype)
        return _attention_decode_batch(cfg, q, cache, idx)

    return _layer_forward_rows(cfg, layers, idx, x, cos, sin, attend, tp=tp)


def _layer_forward_batch_seq(
    cfg: DecoderConfig,
    layers: Dict,
    idx: int,
    x: torch.Tensor,  # [B, T, D]: T new positions per stream
    cache: BatchKVCache,
    cos: torch.Tensor,  # [B·T, hd]
    sin: torch.Tensor,
    streams: torch.Tensor,  # [B, 1] int64 on the device
    positions: torch.Tensor,  # [B, T] int64: pos[b] + t
    tp=Replicated,
) -> torch.Tensor:
    """One layer over B streams × T new positions: rows ``[B·T, D]`` through
    the Q8 kernels; cache writes and attention per stream."""
    B, T, D = x.shape

    def attend(q, k, v):
        n_kv, hd = k.shape[-2:]
        cache.k[:, idx][streams, :, positions] = k.reshape(B, T, n_kv, hd).to(cache.k.dtype)
        cache.v[:, idx][streams, :, positions] = v.reshape(B, T, n_kv, hd).to(cache.v.dtype)
        qb = q.reshape(B, T, *q.shape[1:])
        return torch.cat([
            _attention_unstacked(cfg, qb[b], cache.k[b, idx], cache.v[b, idx], cache.pos_host[b])
            for b in range(B)
        ])

    return _layer_forward_rows(cfg, layers, idx, x.reshape(B * T, D), cos, sin, attend, tp=tp).reshape(B, T, D)


def forward(cfg: DecoderConfig, params: Dict, embeds: torch.Tensor, cache: KVCache, tp=Replicated) -> torch.Tensor:
    """Run all layers over T new positions; returns hidden states [T, D] and
    advances ``cache`` (written in place) by T. A write past the cache's
    capacity raises (the reference's ``dynamic_update_slice`` would clamp it
    and a slice would truncate it, both silently). ``tp``: a mesh's seams
    (``cfg``, ``params`` and ``cache`` then this rank's)."""
    T = embeds.shape[0]
    capacity = cache.k.shape[2]
    if not 0 <= cache.pos <= capacity - T:
        raise ValueError(f"positions {cache.pos}..{cache.pos + T - 1} exceed the cache capacity {capacity}")
    positions = cache.pos + torch.arange(T, device=embeds.device)
    cos, sin = rope_tables(positions, cfg.key_length, cfg.rope_freq_base)
    layers = params["layers"]
    fused_ffn = _use_fused_ffn()
    x = embeds
    for idx in range(cfg.block_count):
        x = _layer_forward(cfg, layers, idx, x, cache, cos, sin, fused_ffn, tp)
    cache.pos += T
    return rms_norm(x, params["final_norm"], cfg.rms_epsilon)


def forward_decode_batch(cfg: DecoderConfig, params: Dict, x: torch.Tensor, cache: BatchKVCache,
                         tp=Replicated) -> torch.Tensor:
    """One decode step for B independent streams (``x [B, D]``, one token
    each); returns hidden states ``[B, D]`` and advances every stream by one.
    The streams ride the matmul row axis, so each layer's weights are read
    once for the batch."""
    cos, sin = rope_tables(cache.pos, cfg.key_length, cfg.rope_freq_base)
    streams = torch.arange(x.shape[0], device=x.device)
    pos = cache.pos.long()
    layers = params["layers"]
    for idx in range(cfg.block_count):
        x = _layer_forward_batch(cfg, layers, idx, x, cache, cos, sin, streams, pos, tp)
    cache.advance(1)
    return rms_norm(x, params["final_norm"], cfg.rms_epsilon)


def forward_prefill_batch(cfg: DecoderConfig, params: Dict, embeds: torch.Tensor,
                          cache: BatchKVCache, tp=Replicated) -> torch.Tensor:
    """Prefill T new positions for each of B streams (``embeds [B, T, D]``);
    returns hidden states ``[B, T, D]`` and advances every stream by T."""
    B, T, _ = embeds.shape
    capacity = cache.k.shape[3]
    if any(p + T > capacity for p in cache.pos_host):
        raise ValueError(f"positions {cache.pos_host} + {T} exceed the cache capacity {capacity}")
    positions = cache.pos.long()[:, None] + torch.arange(T, device=embeds.device)  # [B, T]
    cos, sin = rope_tables(positions.reshape(-1), cfg.key_length, cfg.rope_freq_base)
    streams = torch.arange(B, device=embeds.device)[:, None]
    layers = params["layers"]
    x = embeds
    for idx in range(cfg.block_count):
        x = _layer_forward_batch_seq(cfg, layers, idx, x, cache, cos, sin, streams, positions, tp)
    cache.advance(T)
    return rms_norm(x, params["final_norm"], cfg.rms_epsilon)


def layer_views(layers: Dict) -> List[Dict]:
    """A tree of stacked ``[L, ...]`` leaves as L per-layer trees of views,
    one ``unbind`` a leaf: its backward stacks the L gradients once, where
    indexing layer ``i`` out would zero-fill and accumulate a whole
    ``[L, ...]`` gradient for every layer."""
    per_leaf = {k: layer_views(v) if isinstance(v, dict) else v.unbind(0) for k, v in layers.items()}
    count = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(count)]


def make_train_layer(cfg: DecoderConfig, T: int, device, tp=Replicated):
    """Layer body of the cache-free causal forward (the reference's
    ``make_train_layer``): ``layer_fn(x [..., T, D], layer) -> x`` for one
    layer's tree (:func:`layer_views`).

    The reference's rounding points are kept: every linear's f32 result is
    cast to the residual dtype, attention operands are in ``cfg``'s compute
    dtype with f32 logits and softmax, and the causal mask writes ``NEG_INF``.
    Under tensor parallelism ``cfg`` holds this rank's head and FFN counts and
    ``tp`` its seams (the o and down outputs are summed in f32, before the
    cast)."""
    positions = torch.arange(T, device=device)
    cos, sin = rope_tables(positions, cfg.key_length, cfg.rope_freq_base)
    hd = cfg.key_length
    groups = cfg.head_count // cfg.head_count_kv
    causal = positions[None, :] <= positions[:, None]  # [T, T]
    dtype = torch_dtype(cfg.compute_dtype)
    eps = cfg.rms_epsilon

    def layer_fn(x: torch.Tensor, layer: Dict) -> torch.Tensor:
        lead = x.shape[:-2]
        h = tp.enter(rms_norm(x, layer["attn_norm"], eps))
        rows = dense_matmul(h, layer["qkv"]["w"]).flatten(0, -2)
        q, k, v = (t.reshape(*lead, T, *t.shape[1:]) for t in _split_qkv(cfg, rows, rows.shape[0]))
        q = apply_rope(rms_norm(q, layer["q_norm"], eps), cos, sin)
        k = apply_rope(rms_norm(k, layer["k_norm"], eps), cos, sin)
        qg = q.reshape(*lead, T, cfg.head_count_kv, groups, hd)
        logits = torch.einsum("...qkgd,...ckd->...kgqc", qg.to(dtype).float(), k.to(dtype).float()) * (hd ** -0.5)
        weights = torch.softmax(logits.masked_fill(~causal, NEG_INF), dim=-1)
        attn = torch.einsum("...kgqc,...ckd->...qkgd", weights.to(dtype).float(), v.to(dtype).float())
        attn = attn.reshape(*lead, T, cfg.head_count * hd).to(x.dtype)
        x = x + tp.reduce(dense_matmul(attn, layer["o"]["w"])).to(x.dtype)
        h = tp.enter(rms_norm(x, layer["ffn_norm"], eps))
        gate, up = torch.chunk(dense_matmul(h, layer["gateup"]["w"]), 2, dim=-1)
        inner = (torch.nn.functional.silu(gate) * up).to(x.dtype)
        return x + tp.reduce(dense_matmul(inner, layer["down"]["w"])).to(x.dtype)

    return layer_fn


def forward_train(cfg: DecoderConfig, params: Dict, embeds: torch.Tensor, tp=Replicated) -> torch.Tensor:
    """Cache-free causal forward over whole sequences (training and scoring):
    ``embeds [T, D]`` or ``[B, T, D]`` → hidden states of the same shape.
    Differentiable: the gradients land in the stacked ``[L, ...]`` leaves
    (each layer's weights are views of them). Dense weights only, as
    training takes."""
    layer_fn = make_train_layer(cfg, embeds.shape[-2], embeds.device, tp)
    x = embeds
    for layer in layer_views(params["layers"]):
        x = layer_fn(x, layer)
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


def graphs_engage(cfg: DecoderConfig, device: torch.device, steps: int, tp=Replicated) -> bool:
    """Whether a decode loop of at most ``steps`` steps captures its step as a
    CUDA graph: on a card, without a mesh (``tp.reduce`` is an NCCL call a
    layer), in bf16 compute (precise mode's f32 loop stays eager), and for
    more than one step (a capture costs more than the one eager step it
    would replace)."""
    return device.type == "cuda" and tp is Replicated and cfg.compute_dtype == "bfloat16" and steps > 1


def decode_step(cfg: DecoderConfig, params: Dict, token: torch.Tensor, cache: BatchKVCache,
                tp=Replicated) -> None:
    """One greedy step of B streams, in place: ``token`` (int64 ``[B]``) holds
    each stream's last token and gets its next; each stream's K/V land at its
    device position, which moves on by one (:func:`forward_decode_batch`).
    The step reads and writes only these tensors and the weights, so a
    captured graph of it can be replayed."""
    hidden = forward_decode_batch(cfg, params, embed_tokens(params, token), cache, tp)
    token.copy_(torch.argmax(logits_for(cfg, params, hidden), dim=-1))


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
    budget: Optional[int] = None,
    tp=Replicated,
) -> List[int]:
    """Greedy decode, one step per token with the argmax on the device.

    Returns the generated ids, EOS excluded, at most ``max_new_tokens``, or
    ``budget`` where that is smaller (the speculative tick passes
    ``max_new_tokens`` less its accepted draft; the reference's on-device loop
    records the same ids; its final step, whose token is never recorded, is
    skipped). The step is the batched loop's, :func:`decode_step`, on a
    1-stream view of ``cache`` (:meth:`KVCache.as_batch`), captured and
    replayed where :func:`graphs_engage`; ``cache.pos`` is set from the view
    when the loop ends. With ``LWT_FUSED_FFN`` set and no mesh (the one-launch
    FFN half is a single-stream route) the step is :func:`forward` at the
    host position, eager. Each step is a
    ``model.decode.step`` span, closed by its one sync, the EOS check's
    ``token.item()`` (``model.decode.sync``); ``step_times`` collects the
    steps' walls."""
    limit = max_new_tokens if budget is None else min(max_new_tokens, int(budget))
    generated: List[int] = []
    token = first_token.reshape(1).to(torch.int64, copy=True)  # every step writes its argmax here
    token_id = int(token.item())
    view = None
    if _use_fused_ffn() and tp is Replicated:
        def forward_step() -> None:
            hidden = forward(cfg, params, embed_tokens(params, token), cache, tp)
            token.copy_(torch.argmax(logits_for(cfg, params, hidden[-1:])[-1]).reshape(1))

        runner = contextlib.nullcontext(forward_step)
    else:
        view = cache.as_batch()
        runner = step_graph.StepGraph(lambda: decode_step(cfg, params, token, view, tp), view,
                                      graphs_engage(cfg, token.device, limit - 1, tp))
    try:
        with runner as run:
            while token_id != eos_token_id and len(generated) < limit:
                generated.append(token_id)
                if len(generated) == limit:
                    break
                with tracing.span("model.decode.step") as step:
                    run()
                    with tracing.span("model.decode.sync"):
                        token_id = int(token.item())
                if step_times is not None:
                    step_times.append(step.seconds)
    finally:
        if view is not None:
            cache.pos = view.pos_host[0]
    return generated

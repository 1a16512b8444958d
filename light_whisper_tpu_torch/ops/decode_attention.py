"""GQA decode attention over the head-major KV cache.

Counterpart of ``light_whisper_tpu/ops/decode_attention.py``; the CUDA
kernels are ``csrc/decode_attention.cu``. Three wrappers, one per Pallas
kernel:

- :func:`decode_attention`: layer ``layer`` of the stacked cache
  ``[L, Hkv, C, hd]`` (``decode_attention_pallas_stacked``);
- :func:`decode_attention_unstacked`: one layer's cache ``[Hkv, C, hd]``
  (``decode_attention_pallas``), the per-stream attention of the batched
  prefill. Query row ``t`` of both sits at absolute position ``start + t``
  and attends to cache keys ``0..start + t``;
- :func:`decode_attention_batched`: one query row per stream against layer
  ``layer`` of per-stream caches ``[B, L, Hkv, C, hd]``, stream ``b``
  bounded by its own position ``pos[b]`` (``decode_attention_pallas_batched``).

A CPU tensor takes the plain PyTorch version in this module; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches per wrapper.
"""

from __future__ import annotations

from typing import Sequence

import torch

from light_whisper_tpu_torch.ops import _build

NEG_INF = -1e30
MAX_ROWS = 64  # the decoder routes 1 <= T <= 64 here
KERNEL_HEAD_DIMS = (64, 128, 256)

LAUNCHES = {"decode_attention": 0, "decode_attention_unstacked": 0, "decode_attention_batched": 0}


def attention_plain(
    q: torch.Tensor,  # [T, Hq, hd]
    k_layer: torch.Tensor,  # [Hkv, C, hd]
    v_layer: torch.Tensor,
    start: int,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Masked-softmax GQA attention: logits f32 from ``dtype`` operands, times
    hd^-1/2, keys past each row's position at -1e30, f32 softmax, weights cast
    to ``dtype`` for p·v, f32 accumulation. Returns f32 ``[T, Hq, hd]``."""
    T, n_heads, hd = q.shape
    n_kv, capacity, _ = k_layer.shape
    groups = n_heads // n_kv
    qg = q.reshape(T, n_kv, groups, hd).permute(1, 2, 0, 3)  # [Hkv, G, T, hd]
    kf = k_layer.to(dtype).float()
    logits = torch.einsum("kgtd,kcd->kgtc", qg.to(dtype).float(), kf) * (hd ** -0.5)
    key_pos = torch.arange(capacity, device=q.device)
    q_pos = start + torch.arange(T, device=q.device)
    mask = key_pos[None, :] <= q_pos[:, None]  # [T, C]
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("kgtc,kcd->kgtd", weights.to(dtype).float(), v_layer.to(dtype).float())
    return out.permute(2, 0, 1, 3).reshape(T, n_heads, hd)


def decode_attention_plain(q, k_cache, v_cache, start: int, layer: int) -> torch.Tensor:
    """Plain version of :func:`decode_attention` (bf16 operands)."""
    return attention_plain(q, k_cache[layer], v_cache[layer], start)


def decode_attention_batched_plain(
    q: torch.Tensor,  # [B, Hq, hd]
    k_all: torch.Tensor,  # [B, L, Hkv, C, hd]
    v_all: torch.Tensor,
    pos: torch.Tensor,  # [B] int
    layer: int,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version of :func:`decode_attention_batched` (the reference's
    ``_attention_decode_batch``): stream ``b`` sees keys ``0..pos[b]`` of its
    own cache; ``dtype`` operands as in :func:`attention_plain`. Returns f32
    ``[B, Hq, hd]``."""
    B, n_heads, hd = q.shape
    n_kv, capacity = k_all.shape[2], k_all.shape[3]
    qg = q.reshape(B, n_kv, n_heads // n_kv, hd).to(dtype).float()
    logits = torch.einsum("bkgd,bkcd->bkgc", qg, k_all[:, layer].to(dtype).float()) * (hd ** -0.5)
    mask = torch.arange(capacity, device=q.device)[None, :] <= pos.to(q.device)[:, None]  # [B, C]
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgc,bkcd->bkgd", weights.to(dtype).float(), v_all[:, layer].to(dtype).float())
    return out.reshape(B, n_heads, hd)


def _require(checks) -> None:
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)


def _cache_checks(q, k, v, hd):
    return (
        (k.dtype == torch.bfloat16 and v.dtype == torch.bfloat16, "cache must be bf16"),
        (v.shape == k.shape, "k/v cache shapes differ"),
        (k.device == q.device and v.device == q.device, "cache not on q's device"),
        (k.is_contiguous() and v.is_contiguous(), "cache must be contiguous"),
        (k.shape[-1] == hd and hd in KERNEL_HEAD_DIMS, f"head dim {hd} not in {KERNEL_HEAD_DIMS}"),
        (q.shape[-2] % k.shape[-3] == 0, f"{q.shape[-2]} heads not a multiple of {k.shape[-3]} kv heads"),
    )


def _device_kind(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return q.device.type


def _launch_rows(q, k_layer, v_layer, start: int, counter: str) -> torch.Tensor:
    """``lwt_decode_attention`` on one layer's ``[Hkv, C, hd]`` block."""
    T, n_heads, hd = q.shape
    n_kv, capacity, _ = k_layer.shape
    _require(_cache_checks(q, k_layer, v_layer, hd) + (
        (1 <= T <= MAX_ROWS, f"T={T} outside 1..{MAX_ROWS}"),
        (0 <= start and start + T <= capacity, f"positions {start}..{start + T - 1} exceed {capacity}"),
    ))
    q = q.to(torch.bfloat16).contiguous()
    out = torch.empty((T, n_heads, hd), dtype=torch.float32, device=q.device)
    err = _build.library().lwt_decode_attention(
        q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(), out.data_ptr(),
        T, n_heads, n_kv, capacity, hd, int(start), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "lwt_decode_attention")
    LAUNCHES[counter] += 1
    return out


def decode_attention(
    q: torch.Tensor,  # [T, Hq, hd]
    k_cache: torch.Tensor,  # [L, Hkv, C, hd] bf16
    v_cache: torch.Tensor,
    start: int,
    layer: int,
) -> torch.Tensor:
    """Attention of T query rows against layer ``layer`` of the stacked cache."""
    if _device_kind(q) == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, start, layer)
    _require(((k_cache.dim() == 4 and 0 <= layer < k_cache.shape[0],
               f"layer {layer} outside a stacked cache of shape {tuple(k_cache.shape)}"),))
    return _launch_rows(q, k_cache[layer], v_cache[layer], start, "decode_attention")


def decode_attention_unstacked(
    q: torch.Tensor,  # [T, Hq, hd]
    k_layer: torch.Tensor,  # [Hkv, C, hd] bf16
    v_layer: torch.Tensor,
    start: int,
) -> torch.Tensor:
    """Attention of T query rows against one layer's cache ``[Hkv, C, hd]``."""
    if _device_kind(q) == "cpu":
        return attention_plain(q, k_layer, v_layer, start)
    _require(((k_layer.dim() == 3, f"cache must be [Hkv, C, hd], got {tuple(k_layer.shape)}"),))
    return _launch_rows(q, k_layer, v_layer, start, "decode_attention_unstacked")


def decode_attention_batched(
    q: torch.Tensor,  # [B, Hq, hd]
    k_all: torch.Tensor,  # [B, L, Hkv, C, hd] bf16
    v_all: torch.Tensor,
    pos: torch.Tensor,  # [B] int32 on q's device
    layer: int,
    pos_host: Sequence[int],  # the host's copy of ``pos``, for the bounds check
) -> torch.Tensor:
    """One query row per stream against layer ``layer`` of its own cache;
    stream ``b`` sees keys ``0..pos[b]``. Returns f32 ``[B, Hq, hd]``."""
    B, n_heads, hd = q.shape
    _require((
        (k_all.dim() == 5 and k_all.shape[0] == B, f"cache must be [{B}, L, Hkv, C, hd], got {tuple(k_all.shape)}"),
        (0 <= layer < k_all.shape[1], f"layer {layer} outside 0..{k_all.shape[1] - 1}"),
        (tuple(pos.shape) == (B,) and len(pos_host) == B, f"pos must hold {B} positions"),
        (all(0 <= p < k_all.shape[3] for p in pos_host), f"positions {list(pos_host)} exceed {k_all.shape[3]}"),
    ))
    if _device_kind(q) == "cpu":
        return decode_attention_batched_plain(q, k_all, v_all, pos, layer)
    _require(_cache_checks(q, k_all, v_all, hd) + (
        (pos.dtype == torch.int32 and pos.device == q.device and pos.is_contiguous(),
         "pos must be contiguous int32 on q's device"),
    ))
    _, L, n_kv, capacity, _ = k_all.shape
    q = q.to(torch.bfloat16).contiguous()
    out = torch.empty((B, n_heads, hd), dtype=torch.float32, device=q.device)
    err = _build.library().lwt_decode_attention_batched(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, n_heads, n_kv, capacity, L, hd, int(layer), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "lwt_decode_attention_batched")
    LAUNCHES["decode_attention_batched"] += 1
    return out

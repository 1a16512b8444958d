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

The kernel splits each work unit's live keys over a cluster of
:func:`split_count` CTAs and merges the row statistics and partial outputs
in rank order; :func:`attention_split_plain` and
:func:`decode_attention_batched_split_plain` run that schedule's arithmetic
in torch, so the split and merge are tested where the kernel cannot run.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from light_whisper_tpu_torch.ops import _build

NEG_INF = -1e30
MAX_ROWS = 64  # the decoder routes 1 <= T <= 64 here
KERNEL_HEAD_DIMS = (64, 128, 256)
TILE_ROWS = 64  # flattened query rows (row = t * G + g) a work unit of the kernel
MAX_SPLITS = 16  # the largest thread-block cluster Hopper schedules (above 8: non-portable)
LONG_CAPACITY = 4096  # caches of more slots than this split 16 ways, others 8
MIN_SPLIT_KEYS = 64  # cache slots a split covers at least

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


def split_count(capacity: int) -> int:
    """CTAs (one cluster) that share each work unit's live keys in the kernel:
    16 for caches of more than 4096 slots, 8 otherwise, fewer where a split
    would cover less than 64 slots.

    A function of the cache capacity only. Never of the live positions, so a
    captured launch stays valid while they move; and not of the number of
    streams or rows, so a stream's attention is the same to the bit whether
    it decodes alone (``decode_attention``) or in a batch
    (``decode_attention_batched``): the f32 sums of a split run in an order
    set by the split, and the batched and per-stream decodes must agree
    token for token, as the reference's do."""
    splits = MAX_SPLITS if capacity > LONG_CAPACITY else MAX_SPLITS // 2
    while splits > 1 and capacity < splits * MIN_SPLIT_KEYS:
        splits //= 2
    return splits


def resident_clusters(T: int, n_heads: int, n_kv: int, capacity: int, hd: int, splits: int) -> int:
    """How many clusters of ``splits`` CTAs of the kernel that T query rows
    over a cache of ``capacity`` slots take the current card holds at once
    (launches nothing; needs a GPU)."""
    clusters = ctypes.c_int(0)
    _build.check(_build.library().lwt_decode_attention_clusters(T, n_heads, n_kv, capacity, hd, splits,
                                                               ctypes.byref(clusters)),
                 "lwt_decode_attention_clusters")
    return clusters.value


def _split_rows(qr, k_layer, v_layer, pos_rows, splits: int, dtype) -> torch.Tensor:
    """The kernel's schedule on one stream: ``qr`` [Hkv, R, hd] flattened
    rows, row r bounded by ``pos_rows[r]``; rows in tiles of 64, each tile's
    live keys split evenly ``splits`` ways; per split the local max and
    denominator, merged in rank order; p = bf16(exp(s - m) / l) from the
    merged statistics; per-split f32 partials p·v summed in rank order.
    Returns f32 [Hkv, R, hd]."""
    n_kv, n_rows, hd = qr.shape
    logits = torch.einsum("krd,kcd->krc", qr.to(dtype).float(), k_layer.to(dtype).float()) * (hd ** -0.5)
    vf = v_layer.to(dtype).float()
    out = torch.zeros((n_kv, n_rows, hd), dtype=torch.float32, device=qr.device)
    for row0 in range(0, n_rows, TILE_ROWS):
        tile = slice(row0, min(n_rows, row0 + TILE_ROWS))
        pos = pos_rows[tile]
        nkeys = int(pos.max()) + 1
        share = -(-nkeys // splits)
        bounds = [(min(r * share, nkeys), min(r * share + share, nkeys)) for r in range(splits)]
        s = logits[:, tile, :nkeys]
        valid = torch.arange(nkeys, device=qr.device)[None, :] <= pos[:, None]  # [rows, nkeys]
        m = l = None
        for k0, k1 in bounds:
            ok, sr = valid[:, k0:k1], s[..., k0:k1]
            if k1 > k0:
                m_r = torch.where(ok, sr, torch.full_like(sr, NEG_INF)).amax(-1)
                l_r = torch.where(ok, torch.exp(sr - m_r[..., None]), torch.zeros_like(sr)).sum(-1)
            else:  # an empty split: max -1e30, denominator 0
                m_r = torch.full(s.shape[:-1], NEG_INF, device=qr.device)
                l_r = torch.zeros(s.shape[:-1], device=qr.device)
            if m is None:
                m, l = m_r, l_r
            else:
                m_new = torch.maximum(m, m_r)
                l = l * torch.exp(m - m_new) + l_r * torch.exp(m_r - m_new)
                m = m_new
        p = torch.where(valid, torch.exp(s - m[..., None]) / l[..., None], torch.zeros_like(s)).to(dtype).float()
        acc = torch.zeros_like(out[:, tile])
        for k0, k1 in bounds:
            acc = acc + torch.einsum("krc,kcd->krd", p[..., k0:k1], vf[:, k0:k1])
        out[:, tile] = acc
    return out


def attention_split_plain(
    q: torch.Tensor,  # [T, Hq, hd]
    k_layer: torch.Tensor,  # [Hkv, C, hd]
    v_layer: torch.Tensor,
    start: int,
    splits: int,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """:func:`attention_plain` as the kernel schedules it, ``splits`` CTAs a
    work unit (rows flattened time-major, row = t·G + g, at ``start + t``).
    Returns f32 ``[T, Hq, hd]``."""
    T, n_heads, hd = q.shape
    n_kv = k_layer.shape[0]
    groups = n_heads // n_kv
    qr = q.reshape(T, n_kv, groups, hd).transpose(0, 1).reshape(n_kv, T * groups, hd)
    pos_rows = start + torch.arange(T * groups, device=q.device) // groups
    out = _split_rows(qr, k_layer, v_layer, pos_rows, splits, dtype)
    return out.reshape(n_kv, T, groups, hd).transpose(0, 1).reshape(T, n_heads, hd)


def decode_attention_batched_split_plain(
    q: torch.Tensor,  # [B, Hq, hd]
    k_all: torch.Tensor,  # [B, L, Hkv, C, hd]
    v_all: torch.Tensor,
    pos: torch.Tensor,  # [B] int
    layer: int,
    splits: int,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """:func:`decode_attention_batched_plain` as the kernel schedules it: a
    work unit is (stream, KV head), its keys ``0..pos[b]`` split ``splits``
    ways. Returns f32 ``[B, Hq, hd]``."""
    B, n_heads, hd = q.shape
    n_kv = k_all.shape[2]
    groups = n_heads // n_kv
    outs = []
    for b in range(B):
        pos_rows = torch.full((groups,), int(pos[b]), device=q.device)
        outs.append(_split_rows(q[b].reshape(n_kv, groups, hd), k_all[b, layer], v_all[b, layer], pos_rows,
                                splits, dtype).reshape(n_heads, hd))
    return torch.stack(outs)


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
    splits = split_count(capacity)
    err = _build.library().lwt_decode_attention(
        q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(), out.data_ptr(),
        T, n_heads, n_kv, capacity, hd, int(start), splits, float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "lwt_decode_attention")
    _build.count_launch(LAUNCHES, counter)
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
    splits = split_count(capacity)
    err = _build.library().lwt_decode_attention_batched(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, n_heads, n_kv, capacity, L, hd, int(layer), splits, float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "lwt_decode_attention_batched")
    _build.count_launch(LAUNCHES, "decode_attention_batched")
    return out

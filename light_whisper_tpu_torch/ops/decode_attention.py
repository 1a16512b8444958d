"""Layer-indexed GQA decode attention over the head-major KV cache.

Counterpart of ``light_whisper_tpu/ops/decode_attention.py``
(``decode_attention_pallas_stacked``); the CUDA kernel is
``csrc/decode_attention.cu``. Query row ``t`` sits at absolute position
``start + t`` and attends to cache keys ``0..start + t`` of layer ``layer``.

A CPU tensor takes the plain PyTorch version in this module; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from light_whisper_tpu_torch.ops import _build

NEG_INF = -1e30
MAX_ROWS = 64  # the decoder routes 1 <= T <= 64 here
KERNEL_HEAD_DIMS = (64, 128, 256)

LAUNCHES = {"decode_attention": 0}


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


def decode_attention(
    q: torch.Tensor,  # [T, Hq, hd]
    k_cache: torch.Tensor,  # [L, Hkv, C, hd] bf16
    v_cache: torch.Tensor,
    start: int,
    layer: int,
) -> torch.Tensor:
    """Attention of T query rows against layer ``layer`` of the stacked cache."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, start, layer)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    T, n_heads, hd = q.shape
    L, n_kv, capacity, hd_k = k_cache.shape
    checks = (
        (k_cache.dtype == torch.bfloat16 and v_cache.dtype == torch.bfloat16, "cache must be bf16"),
        (v_cache.shape == k_cache.shape, "k/v cache shapes differ"),
        (k_cache.device == q.device and v_cache.device == q.device, "cache not on q's device"),
        (k_cache.is_contiguous() and v_cache.is_contiguous(), "cache must be contiguous"),
        (hd_k == hd and hd in KERNEL_HEAD_DIMS, f"head dim {hd} not in {KERNEL_HEAD_DIMS}"),
        (n_heads % n_kv == 0, f"{n_heads} heads not a multiple of {n_kv} kv heads"),
        (1 <= T <= MAX_ROWS, f"T={T} outside 1..{MAX_ROWS}"),
        (0 <= layer < L, f"layer {layer} outside 0..{L - 1}"),
        (0 <= start and start + T <= capacity, f"positions {start}..{start + T - 1} exceed {capacity}"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    q = q.to(torch.bfloat16).contiguous()
    out = torch.empty((T, n_heads, hd), dtype=torch.float32, device=q.device)
    err = _build.library().lwt_decode_attention(
        q.data_ptr(), k_cache[layer].data_ptr(), v_cache[layer].data_ptr(), out.data_ptr(),
        T, n_heads, n_kv, capacity, hd, int(start), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "lwt_decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out

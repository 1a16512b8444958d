"""Causal prefill attention against a long KV cache, with an online softmax.

Counterpart of ``light_whisper_tpu/ops/flash_prefill.py``: the Pallas kernel
``_flash_rows`` and its wrapper ``flash_prefill_attention``. The CUDA kernel
is ``csrc/flash_prefill.cu``. Query row ``t`` sits at absolute position
``start + t`` and attends to cache keys ``0..start + t``; the query heads of
one KV head share its cache rows (GQA).

:func:`flash_prefill` takes a CPU tensor to :func:`flash_prefill_plain` at the
kernel's key tile; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from light_whisper_tpu_torch.ops import _build

NEG_INF = -1e30
KEY_TILE = 64  # keys a tile of the CUDA kernel (``kKeys`` in csrc/flash_prefill.cu)
HEAD_DIM = 128  # the only head dim the kernel is built for (``kHD``)

LAUNCHES = {"flash_prefill": 0}


def flash_prefill_plain(
    q: torch.Tensor,  # [T, Hq, hd]
    k_layer: torch.Tensor,  # [Hkv, C, hd]
    v_layer: torch.Tensor,
    start: int,
    block_c: int = KEY_TILE,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Online softmax over key blocks of ``block_c``: logits f32 from ``dtype``
    operands times hd^-1/2, keys past each row's position at -1e30, a running
    max and denominator in f32 (the denominator sums the f32 ``p``), ``p`` cast
    to ``dtype`` for p·v with f32 accumulation, then ``acc / l`` (0 where
    ``l == 0``). Returns f32 ``[T, Hq, hd]``.

    ``block_c = 512`` is the TPU kernel's own arithmetic, ``KEY_TILE`` the
    CUDA kernel's. Blocks past the last visible key are skipped: a fully
    masked block leaves the running state unchanged."""
    T, n_heads, hd = q.shape
    n_kv, capacity, _ = k_layer.shape
    qg = q.reshape(T, n_kv, n_heads // n_kv, hd).permute(1, 2, 0, 3).to(dtype).float()  # [Hkv, G, T, hd]
    q_pos = start + torch.arange(T, device=q.device)
    m = torch.full((*qg.shape[:3], 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    n_keys = min(capacity, start + T)
    for base in range(0, n_keys, block_c):
        kb = k_layer[:, base : base + block_c].to(dtype).float()
        vb = v_layer[:, base : base + block_c].to(dtype).float()
        s = torch.einsum("kgtd,kcd->kgtc", qg, kb) * (hd ** -0.5)
        key_pos = base + torch.arange(kb.shape[1], device=q.device)
        allowed = (key_pos[None, :] <= q_pos[:, None])[None, None]  # [1, 1, T, c]
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(allowed, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("kgtc,kcd->kgtd", p.to(dtype).float(), vb)
        m = m_new
    out = torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)), torch.zeros_like(acc))
    return out.permute(2, 0, 1, 3).reshape(T, n_heads, hd)


def flash_prefill(
    q: torch.Tensor,  # [T, Hq, hd]
    k_layer: torch.Tensor,  # [Hkv, C, hd] bf16
    v_layer: torch.Tensor,
    start: int,
) -> torch.Tensor:
    """Causal attention of T query rows against one layer's cache. Returns f32
    ``[T, Hq, hd]``."""
    T, n_heads, hd = q.shape
    if k_layer.dim() != 3:
        raise ValueError(f"cache must be [Hkv, C, hd], got {tuple(k_layer.shape)}")
    n_kv, capacity, _ = k_layer.shape
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_layer, v_layer, start)
    checks = (
        (k_layer.dtype == torch.bfloat16 and v_layer.dtype == torch.bfloat16, "cache must be bf16"),
        (v_layer.shape == k_layer.shape, "k/v cache shapes differ"),
        (k_layer.device == q.device and v_layer.device == q.device, "cache not on q's device"),
        (k_layer.is_contiguous() and v_layer.is_contiguous(), "cache must be contiguous"),
        (hd == HEAD_DIM and k_layer.shape[-1] == hd, f"head dim {hd}: the kernel takes {HEAD_DIM}"),
        (n_heads % n_kv == 0, f"{n_heads} heads not a multiple of {n_kv} kv heads"),
        (T >= 1 and 0 <= start and start + T <= capacity, f"positions {start}..{start + T - 1} exceed {capacity}"),
    )
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q = q.to(torch.bfloat16).contiguous()
    out = torch.empty((T, n_heads, hd), dtype=torch.float32, device=q.device)
    err = _build.library().lwt_flash_prefill(
        q.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(), out.data_ptr(),
        T, n_heads, n_kv, capacity, hd, int(start), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "lwt_flash_prefill")
    LAUNCHES["flash_prefill"] += 1
    return out

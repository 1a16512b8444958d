"""Causal prefill attention against a long KV cache, with an online softmax.

Counterpart of ``light_whisper_tpu/ops/flash_prefill.py``: the Pallas kernel
``_flash_rows`` and its wrapper ``flash_prefill_attention``. The CUDA kernel
is ``csrc/flash_prefill.cu``. Query row ``t`` sits at absolute position
``start + t`` and attends to cache keys ``0..start + t``; the query heads of
one KV head share its cache rows (GQA).

:func:`flash_prefill` takes a CPU tensor to :func:`flash_prefill_plain` at the
kernel's key tile; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches.

The kernel cuts the visible keys of each tile of ``ROW_TILE`` flattened rows
into :func:`prefill_splits` shares, one a CTA of a thread-block cluster, and
merges the shares' online-softmax states in rank order;
:func:`flash_prefill_split_plain` is that schedule in torch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from light_whisper_tpu_torch.ops import _build

NEG_INF = -1e30
KEY_TILE = 64  # keys a tile of the CUDA kernel (``kKeys`` in csrc/flash_prefill.cu)
HEAD_DIM = 128  # the only head dim the kernel is built for (``kHD``)
ROW_TILE = 128  # flattened query rows (row = t * G + g) a CTA (``kRows``)
MAX_SPLITS = 4  # cluster size; at one CTA an SM the H100 holds only 15 clusters of 8 (``kMaxSplits``)
FILL_CTAS = 132  # CTAs up to which the split doubles: the H100's SM count (``kFillCtas``)
MIN_SPLIT_KEYS = 512  # cache slots a split covers at least (``kMinSplitKeys``)

LAUNCHES = {"flash_prefill": 0}


def prefill_splits(T: int, n_heads: int, n_kv: int, capacity: int) -> int:
    """CTAs (one cluster) that share each row tile's visible keys in the
    kernel: doubled while the launch stays within ``FILL_CTAS`` CTAs and each
    split keeps ``MIN_SPLIT_KEYS`` of the capacity, at most ``MAX_SPLITS``.

    A function of the static shapes only, never of ``start``: a captured
    launch stays valid as positions move (as :func:`~light_whisper_tpu_torch.ops.decode_attention.split_count`)."""
    tiles = n_kv * -(-(n_heads // n_kv * T) // ROW_TILE)
    splits = 1
    while splits < MAX_SPLITS and tiles * 2 * splits <= FILL_CTAS and capacity // (2 * splits) >= MIN_SPLIT_KEYS:
        splits *= 2
    return splits


def _online_softmax(qg, k_layer, v_layer, q_pos, k0: int, k1: int, block_c: int, dtype):
    """The online softmax of rows ``qg`` ``[Hkv, G, R, hd]`` (f32 of ``dtype``
    values) at positions ``q_pos`` ``[R]`` over keys ``[k0, k1)``, in blocks of
    ``block_c`` from ``k0``. Returns the running max ``m``, denominator ``l``
    (``[Hkv, G, R, 1]``) and unnormalised ``acc`` (``[Hkv, G, R, hd]``)."""
    hd = qg.shape[-1]
    m = torch.full((*qg.shape[:3], 1), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=qg.device)
    for base in range(k0, k1, block_c):
        end = min(base + block_c, k1)
        kb = k_layer[:, base:end].to(dtype).float()
        vb = v_layer[:, base:end].to(dtype).float()
        s = torch.einsum("kgtd,kcd->kgtc", qg, kb) * (hd ** -0.5)
        key_pos = torch.arange(base, end, device=qg.device)
        allowed = (key_pos[None, :] <= q_pos[:, None])[None, None]  # [1, 1, R, c]
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(allowed, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("kgtc,kcd->kgtd", p.to(dtype).float(), vb)
        m = m_new
    return m, l, acc


def _normalise(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """``acc / l``, exactly 0 where ``l == 0``."""
    return torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)), torch.zeros_like(acc))


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
    _, l, acc = _online_softmax(qg, k_layer, v_layer, q_pos, 0, min(capacity, start + T), block_c, dtype)
    return _normalise(acc, l).permute(2, 0, 1, 3).reshape(T, n_heads, hd)


def flash_prefill_split_plain(
    q: torch.Tensor,  # [T, Hq, hd]
    k_layer: torch.Tensor,  # [Hkv, C, hd]
    v_layer: torch.Tensor,
    start: int,
    splits: int,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """:func:`flash_prefill_plain` as the kernel schedules it: rows flattened
    time-major (row = t·G + g) in tiles of ``ROW_TILE``; a tile's visible keys
    ``[0, nkeys)`` cut into ``splits`` shares of ``ceil(nkeys / splits)``, each
    run through the online softmax in ``KEY_TILE`` blocks from its first key
    (an empty share keeps max -1e30 and denominator 0); the shares merged in
    rank order: ``M = max m_r``, ``w_r = exp(m_r - M)``, ``L = Σ l_r·w_r``,
    ``out = Σ acc_r·w_r / L`` (0 where ``L == 0``). Returns f32 ``[T, Hq, hd]``."""
    T, n_heads, hd = q.shape
    n_kv = k_layer.shape[0]
    groups = n_heads // n_kv
    rows = T * groups
    qr = q.reshape(T, n_kv, groups, hd).transpose(0, 1).reshape(n_kv, 1, rows, hd).to(dtype).float()
    pos = start + torch.arange(rows, device=q.device) // groups
    out = torch.zeros((n_kv, 1, rows, hd), dtype=torch.float32, device=q.device)
    for row0 in range(0, rows, ROW_TILE):
        tile = slice(row0, min(rows, row0 + ROW_TILE))
        nkeys = int(pos[tile][-1]) + 1
        share = -(-nkeys // splits)
        states = []
        for rank in range(splits):
            k0 = min(rank * share, nkeys)
            states.append(_online_softmax(qr[:, :, tile], k_layer, v_layer, pos[tile], k0, min(k0 + share, nkeys),
                                          KEY_TILE, dtype))
        top = torch.stack([m for m, _, _ in states]).amax(dim=0)
        total = torch.zeros_like(top)
        acc = torch.zeros_like(states[0][2])
        for m, l, a in states:  # rank order
            w = torch.exp(m - top)
            total = total + l * w
            acc = acc + a * w
        out[:, :, tile] = _normalise(acc, total)
    return out.reshape(n_kv, T, groups, hd).transpose(0, 1).reshape(T, n_heads, hd)


def plan(T: int, n_heads: int, n_kv: int, capacity: int) -> Tuple[int, int]:
    """The kernel's split count for these shapes, as the CUDA source computes
    it, and how many clusters of that many CTAs the current card holds at
    once (launches nothing; needs a GPU)."""
    splits, clusters = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().lwt_flash_prefill_plan(T, n_heads, n_kv, capacity, HEAD_DIM, ctypes.byref(splits),
                                                         ctypes.byref(clusters)), "lwt_flash_prefill_plan")
    return splits.value, clusters.value


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
    _build.count_launch(LAUNCHES, "flash_prefill")
    return out

"""Q8_0 dequant-matmul: ``y[T, out] = x[T, in] @ deq(q[out, in], s[out, in/32]).T``.

Counterpart of ``light_whisper_tpu/ops/q8_matmul.py``. Three wrappers share
one CUDA kernel family (``csrc/q8_matmul.cu``):

- :func:`q8_matmul`: the 2D form (logits head, encoder linears);
- :func:`q8_matmul_stacked`: layer ``layer`` of stacked ``q[L, out, in]``
  (``q[layer]`` is a zero-copy view, so this is the 2D entry at an offset);
- :func:`q8_matmul_stacked_fused`: the stacked form with the rms-norm
  prologue and/or the residual epilogue folded in (T <= 8 only).

A CPU tensor takes the plain PyTorch version in this module; a CUDA tensor
launches the kernel or raises. ``LAUNCHES`` counts kernel launches per form.
Scales are bf16 ``s[out, in/32]`` read directly by the kernel.

The kernel cuts K into chunks of 64 and the chunks into ``S`` contiguous
splits, sums each split's partial in f32 and the partials in rank order
(:func:`q8_matmul_split_plain` is that schedule in torch). ``S`` is
:data:`GEMV_SPLITS` at T <= 8 and :func:`tile_splits` of (N, K) above: never
a function of T, so a row's output is bitwise the same whether it comes in a
call of its own or among other streams' rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from light_whisper_tpu_torch.ops import _build

Q8_0_BLOCK = 32
FUSED_MAX_ROWS = 8
CHUNK = 64  # K a chunk of the kernel's schedule: two Q8 blocks
GEMV_SPLITS = 4  # K splits of every call at T <= 8 (the GEMV's warps)
TILE_N = 128  # output columns a tile of the T > 8 kernel
MAX_SPLITS = 8  # the largest cluster the tile kernel launches
FILL_CTAS = 96  # CTAs of one row tile up to which the split doubles
MIN_SPLIT_CHUNKS = 4  # chunks every split keeps (256 of K)

LAUNCHES = {"q8_matmul": 0, "q8_matmul_stacked": 0, "q8_matmul_stacked_fused": 0}


# -- plain PyTorch versions (CPU path and on-card reference) -----------------


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """bf16 weights ``bf16(q * s)`` — the rounding both TPU paths apply."""
    return q.to(torch.bfloat16) * s.to(torch.bfloat16).repeat_interleave(Q8_0_BLOCK, dim=-1)


def q8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 accumulation (bf16 products are exact in f32)."""
    w = dequantize(q, s).float()
    return torch.matmul(x.to(torch.bfloat16).float(), w.t())


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * w`` in f32, returned in ``x``'s dtype (the
    decoder's norm, and the fused kernel's prologue on bf16 activations)."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * weight.float()).to(x.dtype)


def tile_splits(N: int, K: int) -> int:
    """The K splits (the cluster size) of the T > 8 kernel for ``N`` outputs
    over ``K`` inputs: doubled, up to :data:`MAX_SPLITS`, while one row tile's
    CTAs stay within :data:`FILL_CTAS` and every split keeps
    :data:`MIN_SPLIT_CHUNKS` chunks. A function of (N, K) only; the kernel's
    ``tile_splits`` in ``csrc/q8_matmul.cu`` is the same rule, picked by
    ``scripts/exp_q8_split_sweep.py``."""
    ntiles = -(-N // TILE_N)
    nch = -(-K // CHUNK)
    splits = 1
    while splits < MAX_SPLITS and ntiles * 2 * splits <= FILL_CTAS and nch // (2 * splits) >= MIN_SPLIT_CHUNKS:
        splits *= 2
    return splits


def schedule_splits(T: int, N: int, K: int) -> int:
    """The K splits of a call of T rows: :data:`GEMV_SPLITS` for the GEMV
    (T <= 8), :func:`tile_splits` (N, K) for the tile kernel above."""
    return GEMV_SPLITS if T <= FUSED_MAX_ROWS else tile_splits(N, K)


def split_bounds(K: int, splits: int) -> list:
    """[lo, hi) of K of each split: contiguous runs of 64-wide chunks, split r
    taking chunks [r*n/S, (r+1)*n/S) of the n = ceil(K/64)."""
    nch = -(-K // CHUNK)
    return [(min(r * nch // splits * CHUNK, K), min((r + 1) * nch // splits * CHUNK, K)) for r in range(splits)]


def split_product(x: torch.Tensor, w: torch.Tensor, splits: int) -> torch.Tensor:
    """``bf16(x) · wᵀ`` (``w`` f32 ``[out, in]``) as the kernels sum it: each
    split's partial product in f32, the partials summed in rank order."""
    xf = x.to(torch.bfloat16).float()
    acc = None
    for lo, hi in split_bounds(x.shape[-1], splits):
        part = torch.matmul(xf[..., lo:hi], w[:, lo:hi].t())
        acc = part if acc is None else acc + part
    return acc


def q8_matmul_split_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, splits: int) -> torch.Tensor:
    """The kernel's schedule in torch: each split's partial product in f32,
    the partials summed in rank order (bf16 operands, as
    :func:`q8_matmul_plain`)."""
    return split_product(x, dequantize(q, s).float(), splits)


def q8_matmul_fused_plain(
    x: torch.Tensor,
    q: torch.Tensor,
    s: torch.Tensor,
    norm_w: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """The fused form's plain version; ``splits`` takes the product through
    :func:`q8_matmul_split_plain` (the kernel's schedule) instead."""
    x = x.to(torch.bfloat16)  # the kernel takes bf16 activations (the decoder's hidden state)
    if norm_w is not None:
        x = rms_norm(x, norm_w, eps)
    acc = q8_matmul_plain(x, q, s) if splits is None else q8_matmul_split_plain(x, q, s, splits)
    if residual is not None:
        # the epilogue rounds the accumulator to bf16 before a bf16 add
        acc = (residual.to(torch.bfloat16) + acc.to(torch.bfloat16)).float()
    return acc


# -- kernel launch -------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def _launch(form, x2, q2, s2, norm_w, eps, residual) -> torch.Tensor:
    T, K = x2.shape
    N = q2.shape[0]
    dev = x2.device
    _require(q2.dtype == torch.int8 and q2.shape == (N, K), f"q must be int8 [{N}, {K}]")
    _require(s2.dtype == torch.bfloat16 and s2.shape == (N, K // Q8_0_BLOCK),
             f"s must be bf16 [{N}, {K // Q8_0_BLOCK}]")
    _require(K % Q8_0_BLOCK == 0, f"in features {K} not a multiple of {Q8_0_BLOCK}")
    for name, t in (("q", q2), ("s", s2)):
        _require(t.device == dev, f"{name} on {t.device}, x on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(_aligned(q2), "q must be 16-byte aligned")
    x2 = x2.to(torch.bfloat16).contiguous()
    if not _aligned(x2):
        x2 = x2.clone()
    if norm_w is not None:
        _require(T <= FUSED_MAX_ROWS, f"norm prologue takes T <= {FUSED_MAX_ROWS}, got {T}")
        norm_w = norm_w.to(device=dev, dtype=torch.float32).contiguous()
        _require(norm_w.shape == (K,), f"norm_w must be [{K}]")
        if not _aligned(norm_w):
            norm_w = norm_w.clone()
    if residual is not None:
        _require(T <= FUSED_MAX_ROWS, f"residual epilogue takes T <= {FUSED_MAX_ROWS}, got {T}")
        residual = residual.to(device=dev, dtype=torch.bfloat16).contiguous()
        _require(residual.shape == (T, N), f"residual must be [{T}, {N}]")
    if T <= FUSED_MAX_ROWS:
        staged = T * (-(-K // CHUNK) * CHUNK + 8) * 2  # x rows padded to whole chunks plus 16 bytes
        _require(staged <= 227 * 1024, f"x [{T}, {K}] does not fit the kernel's shared memory")
    y = torch.empty((T, N), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.lwt_q8_matmul(
        x2.data_ptr(), q2.data_ptr(), s2.data_ptr(),
        None if norm_w is None else norm_w.data_ptr(),
        None if residual is None else residual.data_ptr(),
        y.data_ptr(), T, N, K, float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "lwt_q8_matmul")
    _build.count_launch(LAUNCHES, form)
    return y


def resident_clusters(N: int, K: int) -> int:
    """How many clusters of :func:`tile_splits` (N, K) CTAs of the T > 8
    kernel the current card holds at once (launches nothing; needs a GPU).
    Raises if the kernel's own rule disagrees with :func:`tile_splits`."""
    splits, width, clusters = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _build.check(_build.library().lwt_q8_tile_plan(N, K, ctypes.byref(splits), ctypes.byref(width),
                                                   ctypes.byref(clusters)), "lwt_q8_tile_plan")
    _require((splits.value, width.value) == (tile_splits(N, K), TILE_N),
             f"the kernel tiles {N}x{K} {width.value} wide in {splits.value} splits; this module says "
             f"{TILE_N} and {tile_splits(N, K)}")
    return clusters.value


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# -- public wrappers -------------------------------------------------------------


def q8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x[..., in] @ deq(q[out, in], s).T`` → f32 ``[..., out]``."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if _device_kind(x) == "cpu":
        y = q8_matmul_plain(x2, q, s)
    else:
        y = _launch("q8_matmul", x2, q, s, None, 0.0, None)
    return y.reshape(*lead, q.shape[0])


def q8_matmul_stacked(
    x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, layer: int
) -> torch.Tensor:
    """Layer ``layer`` of stacked ``q[L, out, in]`` / ``s[L, out, in/32]``."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if _device_kind(x) == "cpu":
        y = q8_matmul_plain(x2, q[layer], s[layer])
    else:
        y = _launch("q8_matmul_stacked", x2, q[layer], s[layer], None, 0.0, None)
    return y.reshape(*lead, q.shape[1])


def q8_matmul_stacked_fused(
    x: torch.Tensor,
    q: torch.Tensor,
    s: torch.Tensor,
    layer: int,
    norm_w: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stacked form with the rms-norm prologue (``x`` unnormalised) and/or the
    residual epilogue; ``x`` is ``[T, in]`` with T <= 8."""
    T = x.shape[0]
    _require(x.dim() == 2 and T <= FUSED_MAX_ROWS, f"fused form takes x [T<={FUSED_MAX_ROWS}, in]")
    if _device_kind(x) == "cpu":
        return q8_matmul_fused_plain(x, q[layer], s[layer], norm_w, eps, residual)
    return _launch("q8_matmul_stacked_fused", x, q[layer], s[layer], norm_w, eps, residual)

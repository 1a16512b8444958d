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
"""

from __future__ import annotations

from typing import Optional

import torch

from light_whisper_tpu_torch.ops import _build

Q8_0_BLOCK = 32
FUSED_MAX_ROWS = 8

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


def q8_matmul_fused_plain(
    x: torch.Tensor,
    q: torch.Tensor,
    s: torch.Tensor,
    norm_w: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    x = x.to(torch.bfloat16)  # the kernel takes bf16 activations (the decoder's hidden state)
    if norm_w is not None:
        x = rms_norm(x, norm_w, eps)
    acc = q8_matmul_plain(x, q, s)
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
    if residual is not None:
        _require(T <= FUSED_MAX_ROWS, f"residual epilogue takes T <= {FUSED_MAX_ROWS}, got {T}")
        residual = residual.to(device=dev, dtype=torch.bfloat16).contiguous()
        _require(residual.shape == (T, N), f"residual must be [{T}, {N}]")
    if T <= FUSED_MAX_ROWS:
        _require(T * K * 2 <= 227 * 1024, f"x [{T}, {K}] does not fit the kernel's shared memory")
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
    LAUNCHES[form] += 1
    return y


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

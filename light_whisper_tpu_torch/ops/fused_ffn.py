"""Fused decode FFN over stacked Q8_0 weights.

Counterpart of ``light_whisper_tpu/ops/fused_ffn.py``; the CUDA kernel is
``csrc/fused_ffn.cu``:

- :func:`fused_ffn_step`: the whole FFN half of a decode layer in one launch,
  ``x + W_down(silu(W_gate·h) * W_up·h)`` with ``h = rms_norm(x)``, f32 out;
- :func:`fused_gateup_silu`: its first stage alone on an already normalised
  ``h``: ``bf16(silu(gate) * up)``.

Weights are the loader's: ``gateup_q [L, 2F, D]`` int8 (gate rows ``[0, F)``,
up rows ``[F, 2F)``), ``gateup_s [L, 2F, D/32]`` bf16, ``down_q [L, D, F]``,
``down_s [L, D, F/32]``; layer ``layer`` is a view. Both take at most 8 rows.

A CPU tensor takes the plain version at the kernel's tile of 32 columns; a
CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from light_whisper_tpu_torch.ops import _build
from light_whisper_tpu_torch.ops.q8_matmul import (
    FUSED_MAX_ROWS,
    Q8_0_BLOCK,
    _aligned,
    _device_kind,
    _require,
    dequantize,
    q8_matmul_plain,
    rms_norm,
)

KERNEL_BLOCK_F = 32  # inner columns a partial of the down contraction (one Q8 block; csrc/fused_ffn.cu)

LAUNCHES = {"fused_ffn_step": 0, "fused_gateup_silu": 0}
# The kernel's grid-barrier arrival count, one a (device, stream), and the launches since it was
# last zeroed: each launch adds its grid (one CTA an SM), so it is zeroed, in stream order, every
# BARRIER_RESET launches, long before it could wrap (2^20 launches x 2048 SMs < 2^31).
BARRIER_RESET = 1 << 20
_BARRIERS: Dict[Tuple[int, int], torch.Tensor] = {}
_BARRIER_USES: Dict[Tuple[int, int], int] = {}


# -- plain PyTorch versions (CPU path and on-card reference) -------------------


def fused_gateup_silu_plain(h: torch.Tensor, gateup_q: torch.Tensor, gateup_s: torch.Tensor,
                            layer: int) -> torch.Tensor:
    """``bf16(g·σ(g)·u)`` of ``gate, up = h @ deq(gateup).T`` (f32 accumulation)."""
    gate, up = torch.chunk(q8_matmul_plain(h, gateup_q[layer], gateup_s[layer]), 2, dim=-1)
    return (gate * torch.sigmoid(gate) * up).to(torch.bfloat16)


def fused_ffn_step_plain(x: torch.Tensor, norm_w: torch.Tensor, gateup_q: torch.Tensor, gateup_s: torch.Tensor,
                         down_q: torch.Tensor, down_s: torch.Tensor, layer: int, eps: float = 1e-6,
                         block_f: int = KERNEL_BLOCK_F) -> torch.Tensor:
    """The TPU kernel's arithmetic at ``block_f``: ``h = bf16(x·rsqrt(mean(x²)+eps)·w)``,
    ``inner`` as :func:`fused_gateup_silu_plain`, then ``o = f32(x) + p₀``,
    ``o += pⱼ`` tile by tile, ``pⱼ`` the down contraction over ``block_f`` columns."""
    x = x.to(torch.bfloat16)
    inner = fused_gateup_silu_plain(rms_norm(x, norm_w, eps), gateup_q, gateup_s, layer).float()
    w_down = dequantize(down_q[layer], down_s[layer]).float()  # [D, F]
    out = x.float()
    for f0 in range(0, inner.shape[-1], block_f):
        out = out + torch.matmul(inner[:, f0 : f0 + block_f], w_down[:, f0 : f0 + block_f].t())
    return out


# -- kernel launch ---------------------------------------------------------------


def _check_rows(x: torch.Tensor, what: str) -> None:
    _require(x.dim() == 2 and 1 <= x.shape[0] <= FUSED_MAX_ROWS,
             f"{what} takes [T<={FUSED_MAX_ROWS}, D], got {tuple(x.shape)}")


def _check_weights(dev, named) -> None:
    for name, t, dtype in named:
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(t.device == dev, f"{name} on {t.device}, x on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
        _require(_aligned(t), f"{name} must be 16-byte aligned")


def _barrier(dev: torch.device, stream: int) -> torch.Tensor:
    """The barrier words for a launch on ``stream``, zeroed first when due."""
    key = (dev.index, stream)
    words = _BARRIERS.get(key)
    if words is None:
        words = _BARRIERS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    elif _BARRIER_USES[key] >= BARRIER_RESET:
        words.zero_()  # on the current stream: after every earlier launch, before this one
        _BARRIER_USES[key] = 0
    _BARRIER_USES[key] = _BARRIER_USES.get(key, 0) + 1
    return words


def _gateup_dims(x: torch.Tensor, gateup_q: torch.Tensor, gateup_s: torch.Tensor):
    T, D = x.shape
    _require(gateup_q.dim() == 3 and gateup_q.shape[2] == D and gateup_q.shape[1] % 2 == 0,
             f"gateup_q must be [L, 2F, {D}], got {tuple(gateup_q.shape)}")
    F = gateup_q.shape[1] // 2
    _require(D % Q8_0_BLOCK == 0 and F % Q8_0_BLOCK == 0, f"D {D} and F {F} must be multiples of {Q8_0_BLOCK}")
    _require(tuple(gateup_s.shape) == (gateup_q.shape[0], 2 * F, D // Q8_0_BLOCK),
             f"gateup_s must be [L, {2 * F}, {D // Q8_0_BLOCK}]")
    return T, D, F


def fused_gateup_silu(h: torch.Tensor, gateup_q: torch.Tensor, gateup_s: torch.Tensor, layer: int) -> torch.Tensor:
    """``bf16(silu(gate(h)) * up(h))`` of layer ``layer`` → ``[T, F]``; ``h`` is
    normalised, ``[T<=8, D]``."""
    _check_rows(h, "fused_gateup_silu")
    if _device_kind(h) == "cpu":
        return fused_gateup_silu_plain(h, gateup_q, gateup_s, layer)
    T, D, F = _gateup_dims(h, gateup_q, gateup_s)
    dev = h.device
    gq, gs = gateup_q[layer], gateup_s[layer]
    _check_weights(dev, (("gateup_q", gq, torch.int8), ("gateup_s", gs, torch.bfloat16)))
    h = h.to(torch.bfloat16).contiguous()
    if not _aligned(h):  # the kernel stages h with 16-byte loads
        h = h.clone()
    inner = torch.empty((T, F), dtype=torch.bfloat16, device=dev)
    err = _build.library().lwt_fused_gateup_silu(
        h.data_ptr(), gq.data_ptr(), gs.data_ptr(), inner.data_ptr(), T, D, F,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lwt_fused_gateup_silu")
    _build.count_launch(LAUNCHES, "fused_gateup_silu")
    return inner


def fused_ffn_step(x: torch.Tensor, norm_w: torch.Tensor, gateup_q: torch.Tensor, gateup_s: torch.Tensor,
                   down_q: torch.Tensor, down_s: torch.Tensor, layer: int, eps: float = 1e-6) -> torch.Tensor:
    """One fused FFN decode step of layer ``layer``: ``x + down(silu(gate)·up)``
    of ``rms_norm(x, norm_w)``, f32 ``[T, D]``; ``x`` is ``[T<=8, D]``."""
    _check_rows(x, "fused_ffn_step")
    if _device_kind(x) == "cpu":
        return fused_ffn_step_plain(x, norm_w, gateup_q, gateup_s, down_q, down_s, layer, eps)
    T, D, F = _gateup_dims(x, gateup_q, gateup_s)
    _require(tuple(down_q.shape[1:]) == (D, F) and tuple(down_s.shape[1:]) == (D, F // Q8_0_BLOCK),
             f"down_q / down_s must be [L, {D}, {F}] / [L, {D}, {F // Q8_0_BLOCK}]")
    # the kernel copies each down scale row into shared memory 4 bytes at a time
    _require(F % (2 * Q8_0_BLOCK) == 0, f"F {F} must be a multiple of {2 * Q8_0_BLOCK}")
    dev = x.device
    gq, gs, dq, ds = gateup_q[layer], gateup_s[layer], down_q[layer], down_s[layer]
    _check_weights(dev, (("gateup_q", gq, torch.int8), ("gateup_s", gs, torch.bfloat16),
                         ("down_q", dq, torch.int8), ("down_s", ds, torch.bfloat16)))
    x = x.to(torch.bfloat16).contiguous()
    if not _aligned(x):  # the kernel stages x with 16-byte loads
        x = x.clone()
    norm_w = norm_w.to(device=dev, dtype=torch.float32).contiguous()
    _require(norm_w.shape == (D,), f"norm_w must be [{D}]")
    stream = torch.cuda.current_stream(dev).cuda_stream
    inner = torch.empty((T + T % 2, F), dtype=torch.bfloat16, device=dev)  # scratch: [F/8][T rounded up][8]
    y = torch.empty((T, D), dtype=torch.float32, device=dev)
    err = _build.library().lwt_fused_ffn_step(
        x.data_ptr(), norm_w.data_ptr(), gq.data_ptr(), gs.data_ptr(), dq.data_ptr(), ds.data_ptr(),
        inner.data_ptr(), y.data_ptr(), _barrier(dev, stream).data_ptr(), T, D, F, float(eps), stream)
    _build.check(err, "lwt_fused_ffn_step")
    _build.count_launch(LAUNCHES, "fused_ffn_step")
    return y

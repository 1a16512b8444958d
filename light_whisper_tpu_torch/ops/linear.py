"""Linear layers over dense or Q8_0 weights (counterpart of ``ops/linear.py``).

- dense: ``{"w": [in, out]}`` (+ optional ``"b": [out]``), applied as ``x @ w``;
- Q8_0:  ``{"q": int8 [out, in], "s": bf16 [out, in / 32]}`` (+ optional ``"b"``).

Every Q8 linear goes through :func:`ops.q8_matmul.q8_matmul`, whatever its
shape: the TPU tiling gate of the JAX package has no counterpart here. All
contractions accumulate in f32 and the bias is added in f32.
"""

from __future__ import annotations

from typing import Dict

import torch

from light_whisper_tpu_torch.ops.q8_matmul import q8_matmul


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` cast to ``x``'s dtype and f32 accumulation."""
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    return torch.matmul(x.float(), w.float())


def apply_linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Apply a dense or Q8_0 linear parameter dict to ``x`` (f32 result)."""
    if "q" in p:
        out = q8_matmul(x, p["q"], p["s"])
    else:
        out = dense_matmul(x, p["w"])
    if "b" in p:
        out = out + p["b"].float()
    return out

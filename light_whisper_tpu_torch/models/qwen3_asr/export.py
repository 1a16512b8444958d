"""Write Qwen3-ASR GGUF artifacts (tests, tiny models, HF conversion).

The port's copy of ``light_whisper_tpu/models/qwen3_asr/export.py``.

Counterpart of :mod:`.loader`: takes (out, in)-oriented numpy tensors under
the same names and emits a GGUF the engine can serve. Tensors listed in
``QUANTIZABLE`` are stored Q8_0 when ``quantize=True`` (matmul weights whose
in-features divide 32); norms, biases and convs stay f32 — mirroring how the
reference artifacts keep Q8_0 for the big matrices only.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np

from light_whisper_tpu_torch.formats import gguf
from light_whisper_tpu_torch.models.qwen3_asr.config import Qwen3ASRConfig, metadata_from_config

_QUANT_PATTERNS = [
    r"^token_embd\.weight$",
    r"^output\.weight$",
    r"^blk\.\d+\.(attn_q|attn_k|attn_v|attn_output|ffn_gate|ffn_up|ffn_down)\.weight$",
    r"^aenc\.(blk\.\d+\.)?(attn_q|attn_k|attn_v|attn_output|ffn_up|ffn_down|conv_out|proj1|proj2)\.weight$",
]


def _should_quantize(name: str, arr: np.ndarray) -> bool:
    if arr.ndim != 2 or arr.shape[-1] % gguf.Q8_0_BLOCK != 0:
        return False
    return any(re.match(p, name) for p in _QUANT_PATTERNS)


def write_model(
    path: str,
    cfg: Qwen3ASRConfig,
    tensors: Dict[str, np.ndarray],
    tokenizer_meta: Optional[Dict[str, Any]] = None,
    quantize: bool = True,
    extra_metadata: Optional[Dict[str, Any]] = None,
    quant_type: int = gguf.GGML_Q8_0,  # or gguf.GGML_Q4_0
) -> None:
    metadata = metadata_from_config(cfg)
    if tokenizer_meta:
        metadata.update(tokenizer_meta)
    if extra_metadata:
        metadata.update(extra_metadata)

    spec: Dict[str, Any] = {}
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        if quantize and _should_quantize(name, arr):
            spec[name] = (arr, quant_type)
        else:
            spec[name] = arr.astype(np.float32)
    gguf.write_gguf(path, metadata, spec)

"""Tensor-name canonicalization + rope-layout adapters for GGUF artifacts.

The port's copy of ``light_whisper_tpu/models/qwen3_asr/names.py``.

The loader's native scheme is llama.cpp-style for the decoder (``blk.N.*``,
``token_embd.weight``) plus an ``aenc.*`` prefix for the audio tower. Real
``handy-computer/Qwen3-ASR-*-gguf`` artifacts (the files the reference
serves — ``hf_cache_utils.py:11-26``) are not inspectable in this
environment, so this module accepts the plausible conventions a converter
would emit and maps them onto the canonical names:

- **HF transformers** (`Qwen3OmniMoe` thinker/audio-tower module paths, as a
  naive safetensors→GGUF convert would name them):
  ``model.layers.N.self_attn.q_proj.weight`` → ``blk.N.attn_q.weight``,
  ``audio_tower.layers.N.fc1.weight`` → ``aenc.blk.N.ffn_up.weight``, …
- **llama.cpp mmproj-style audio prefix**: ``a.blk.N.*`` → ``aenc.blk.N.*``,
  ``a.post_ln.*`` → ``aenc.ln_post.*``.

Rope layout: our decoder applies HF half-split rotate-half rope
(``decoder.py:apply_rope``). llama.cpp's LLaMA converts permute q/k rows
into interleaved order; Qwen-family converts use NEOX rope and should not —
but if an artifact declares ``qwen3asr.rope_permutation = "llama"`` in its
metadata, the loader un-permutes q/k rows (and the per-head-dim q/k norm
vectors) back to rotate-half order at load time.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable

import numpy as np

# HF decoder-layer module → canonical suffix
_DEC_LAYER = {
    "self_attn.q_proj": "attn_q",
    "self_attn.k_proj": "attn_k",
    "self_attn.v_proj": "attn_v",
    "self_attn.o_proj": "attn_output",
    "self_attn.q_norm": "attn_q_norm",
    "self_attn.k_norm": "attn_k_norm",
    "input_layernorm": "attn_norm",
    "post_attention_layernorm": "ffn_norm",
    "mlp.gate_proj": "ffn_gate",
    "mlp.up_proj": "ffn_up",
    "mlp.down_proj": "ffn_down",
}

# HF audio-tower layer module → canonical suffix
_ENC_LAYER = {
    "self_attn.q_proj": "attn_q",
    "self_attn.k_proj": "attn_k",
    "self_attn.v_proj": "attn_v",
    "self_attn.out_proj": "attn_output",
    "self_attn_layer_norm": "attn_norm",
    "final_layer_norm": "ffn_norm",
    "fc1": "ffn_up",
    "fc2": "ffn_down",
}

# HF audio-tower top-level module → canonical aenc name
_ENC_TOP = {
    "conv2d1": "conv1",
    "conv2d2": "conv2",
    "conv2d3": "conv3",
    "conv_out": "conv_out",
    "ln_post": "ln_post",
    "proj1": "proj1",
    "proj2": "proj2",
}

# llama.cpp mmproj-ish audio aliases (within an ``a.`` / ``aenc.`` prefix)
_MMPROJ_ALIASES = {
    "post_ln": "ln_post",
}

_HF_DEC_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+?)\.(weight|bias)$")
_HF_ENC_LAYER_RE = re.compile(r"^audio_tower\.layers\.(\d+)\.(.+?)\.(weight|bias)$")
_HF_ENC_TOP_RE = re.compile(r"^audio_tower\.(.+?)\.(weight|bias)$")
_A_PREFIX_RE = re.compile(r"^a\.(.+)$")


def canonical_name(name: str) -> str:
    """Map one tensor name onto the loader's canonical scheme.

    Unrecognized names pass through unchanged (the loader's KeyError on a
    truly missing tensor stays the authoritative failure).
    """
    if name.startswith("thinker."):
        name = name[len("thinker.") :]

    m = _A_PREFIX_RE.match(name)
    if m:
        rest = m.group(1)
        for alias, canon in _MMPROJ_ALIASES.items():
            rest = re.sub(rf"(^|\.){re.escape(alias)}\.", rf"\g<1>{canon}.", rest)
        return "aenc." + rest

    m = _HF_DEC_LAYER_RE.match(name)
    if m and m.group(2) in _DEC_LAYER:
        return f"blk.{m.group(1)}.{_DEC_LAYER[m.group(2)]}.{m.group(3)}"

    m = _HF_ENC_LAYER_RE.match(name)
    if m and m.group(2) in _ENC_LAYER:
        return f"aenc.blk.{m.group(1)}.{_ENC_LAYER[m.group(2)]}.{m.group(3)}"

    m = _HF_ENC_TOP_RE.match(name)
    if m and m.group(1) in _ENC_TOP:
        return f"aenc.{_ENC_TOP[m.group(1)]}.{m.group(2)}"

    if name == "model.embed_tokens.weight":
        return "token_embd.weight"
    if name == "model.norm.weight":
        return "output_norm.weight"
    if name == "lm_head.weight":
        return "output.weight"
    return name


def canonicalize(tensors: Dict[str, object]) -> Dict[str, object]:
    """Return a view of ``tensors`` keyed by canonical names.

    Raises if two source names collapse onto one canonical name — that means
    a mixed-convention artifact, which is better rejected than guessed at.
    """
    out: Dict[str, object] = {}
    for name, tensor in tensors.items():
        canon = canonical_name(name)
        if canon in out:
            raise ValueError(f"tensor name collision: {name!r} → {canon!r}")
        out[canon] = tensor
    return out


# ---------------------------------------------------------------------------
# rope permutation


def llama_permute_rows(n_rows: int, n_head: int) -> np.ndarray:
    """Forward (convert-side) row map: ``permuted = orig[this]``.

    Mirrors llama.cpp ``convert_hf_to_gguf.permute``:
    reshape(n_head, 2, hd/2, …).swapaxes(1, 2).
    """
    hd = n_rows // n_head
    return (
        np.arange(n_rows).reshape(n_head, 2, hd // 2).swapaxes(1, 2).reshape(n_rows)
    )


def llama_unpermute_rows(n_rows: int, n_head: int) -> np.ndarray:
    """Inverse row map: ``orig = permuted[this]``."""
    return np.argsort(llama_permute_rows(n_rows, n_head))


def llama_permute_head_dim(head_dim: int) -> np.ndarray:
    """The same component shuffle restricted to one head (for the per-head
    q/k RMS-norm weight vectors)."""
    return llama_permute_rows(head_dim, 1)


def llama_unpermute_head_dim(head_dim: int) -> np.ndarray:
    return np.argsort(llama_permute_head_dim(head_dim))

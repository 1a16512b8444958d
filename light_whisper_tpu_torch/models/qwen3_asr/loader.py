"""GGUF → parameter trees on the device (counterpart of ``models/qwen3_asr/loader.py``).

Trees and layouts are bit-identical to the reference's ``Qwen3ASRWeights``:
Q8_0 (and Q4_0, expanded to int8 quants) as ``{"q": int8 [out, in], "s": bf16
[out, in/32]}``, dense matrices as bf16 ``[in, out]``, norms/biases/convs f32,
per-layer leaves stacked on a leading axis, q/k/v and gate/up fused along
out-features, and the embedding padded to a multiple of 1024 rows.

Everything is filled into host numpy/torch tensors first (quantised tensors
split straight from the mmap into their stacked destination), then each leaf
crosses to the device in one copy. The f16 → bf16 scale conversion runs in
torch and rounds to nearest-even, as the reference's host conversion does.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from light_whisper_tpu_torch.formats import gguf
from light_whisper_tpu_torch.models.qwen3_asr import names as _names
from light_whisper_tpu_torch.models.qwen3_asr.config import Qwen3ASRConfig, config_from_metadata
from light_whisper_tpu_torch.models.qwen3_asr.tokenizer import BPETokenizer, tokenizer_from_metadata
from light_whisper_tpu_torch.models.qwen3_asr.encoder import sinusoid_positions

VOCAB_PAD_MULTIPLE = 1024
_QUANTIZED = (gguf.GGML_Q8_0, gguf.GGML_Q4_0)

DECODER_PROJ_NAMES = (
    "attn_q.weight",
    "attn_k.weight",
    "attn_v.weight",
    "attn_output.weight",
    "ffn_gate.weight",
    "ffn_up.weight",
    "ffn_down.weight",
)
ENCODER_LINEARS = {
    "q": "attn_q",
    "k": "attn_k",
    "v": "attn_v",
    "o": "attn_output",
    "fc1": "ffn_up",
    "fc2": "ffn_down",
}


def to_bf16(x: np.ndarray) -> torch.Tensor:
    """Host float array → torch bf16, round-to-nearest-even (f16 widens exactly)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)


def _f32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _pad_rows(t: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = -t.shape[0] % multiple
    if pad == 0:
        return t
    return torch.cat([t, torch.zeros((pad, *t.shape[1:]), dtype=t.dtype)], dim=0)


def _stack(trees: List[Dict]) -> Dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _fuse_linears(parts: List[Dict]) -> Dict:
    """Concatenate linears along out-features (one launch instead of several)."""
    if "q" in parts[0]:
        return {"q": torch.cat([p["q"] for p in parts]), "s": torch.cat([p["s"] for p in parts])}
    return {"w": torch.cat([p["w"] for p in parts], dim=1)}  # [in, out]


def _permute_out_rows(p: Dict, perm: torch.Tensor) -> Dict:
    """Reorder out-features: rows of q/s, columns of the [in, out] dense w."""
    if "q" in p:
        return {**p, "q": p["q"][perm], "s": p["s"][perm]}
    return {**p, "w": p["w"][:, perm]}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Qwen3ASRWeights:
    """Parsed artifact: config, tokenizer and parameter trees on ``device``.

    ``precise=True`` loads every weight as dense f32 and marks the config for
    f32 compute (the reference's fidelity mode)."""

    def __init__(self, path: str, device="cpu", precise: bool = False):
        t0 = time.perf_counter()
        f = gguf.read_gguf(path)
        try:
            self.metadata: Dict[str, Any] = f.metadata
            self.config: Qwen3ASRConfig = config_from_metadata(f.metadata)
            if precise:
                self.config = self.config.with_compute_dtype("float32")
            self.precise = precise
            self.tokenizer: BPETokenizer = tokenizer_from_metadata(f.metadata)
            self._tensors = _names.canonicalize(f.tensors)
            self._rope_permutation = str(f.metadata.get("qwen3asr.rope_permutation", "none")).lower()
            if self._rope_permutation not in ("none", "llama"):
                raise ValueError(f"unknown rope_permutation {self._rope_permutation!r}")
            t1 = time.perf_counter()
            dec_host = self._load_decoder()
            ta = time.perf_counter()
            self.decoder_params = _to_device(dec_host, device)
            tb = time.perf_counter()
            del dec_host
            enc_host = self._load_encoder()
            tc = time.perf_counter()
            self.encoder_params = _to_device(enc_host, device)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            td = time.perf_counter()
            del enc_host
        finally:
            self._tensors = None
            f.close()
        self.load_timings = {
            "parse_s": round(t1 - t0, 3),
            "host_prep_s": round((ta - t1) + (tc - tb), 3),
            "device_upload_s": round((tb - ta) + (td - tc), 3),
        }

    # ------------------------------------------------------------------

    def _linear(self, t: gguf.GGUFTensor, bias: Optional[gguf.GGUFTensor] = None) -> Dict:
        if self.precise:
            p = {"w": _f32(t.array().T)}
        elif t.ggml_type in _QUANTIZED:
            q, s = t.q8_0_parts()
            p = {"q": torch.from_numpy(q), "s": to_bf16(s)}
        else:
            p = {"w": to_bf16(t.array().T)}
        if bias is not None:
            p["b"] = _f32(bias.array())
        return p

    def _quantized(self, names) -> bool:
        return not self.precise and all(
            self._tensors.get(n) is not None and self._tensors[n].ggml_type in _QUANTIZED
            for n in names
        )

    def _fill_stacked(self, name_fmts: List[str], count: int, perms=None) -> Dict:
        """Layer-stacked fused ``{q, s}`` split straight from the mmap."""
        t = self._tensors
        shapes = [t[fmt.format(i=0)].shape for fmt in name_fmts]
        kin = shapes[0][1]
        out_total = sum(s[0] for s in shapes)
        q = np.empty((count, out_total, kin), np.int8)
        s = np.empty((count, out_total, kin // gguf.Q8_0_BLOCK), np.float16)
        perms = perms if perms is not None else [None] * len(name_fmts)
        for i in range(count):
            r0 = 0
            for fmt, shp, perm in zip(name_fmts, shapes, perms):
                ten = t[fmt.format(i=i)]
                if ten.shape != shp:
                    raise ValueError(f"{ten.name}: shape {ten.shape} breaks the layer stack ({shp})")
                qv = q[i, r0 : r0 + shp[0]]
                sv = s[i, r0 : r0 + shp[0]]
                if perm is None:
                    ten.q8_0_parts_into(qv, sv)
                else:
                    tq, ts = ten.q8_0_parts()
                    qv[...] = tq[perm]
                    sv[...] = ts[perm]
                r0 += shp[0]
        return {"q": torch.from_numpy(q), "s": to_bf16(s)}

    def _embedding(self, ten: gguf.GGUFTensor) -> Dict:
        if self.precise:
            return {"w": _pad_rows(_f32(ten.array()), VOCAB_PAD_MULTIPLE)}
        if ten.ggml_type in _QUANTIZED:
            rows, dim = ten.shape
            padded = -(-rows // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE
            q = np.zeros((padded, dim), np.int8)
            s = np.zeros((padded, dim // gguf.Q8_0_BLOCK), np.float16)
            ten.q8_0_parts_into(q[:rows], s[:rows])
            return {"q": torch.from_numpy(q), "s": to_bf16(s)}
        return {"w": _pad_rows(to_bf16(ten.array()), VOCAB_PAD_MULTIPLE)}

    def _vec(self, name: str) -> torch.Tensor:
        return _f32(self._tensors[name].array())

    def _load_decoder(self) -> Dict:
        cfg = self.config.decoder
        t = self._tensors
        L = cfg.block_count
        if self._rope_permutation == "llama":
            unperm_q = _names.llama_unpermute_rows(cfg.head_count * cfg.key_length, cfg.head_count)
            unperm_k = _names.llama_unpermute_rows(cfg.head_count_kv * cfg.key_length, cfg.head_count_kv)
            unperm_hd = _names.llama_unpermute_head_dim(cfg.key_length)
        else:
            unperm_q = unperm_k = unperm_hd = None

        def norm(name: str) -> torch.Tensor:
            v = self._vec(name)
            return v if unperm_hd is None else v[torch.from_numpy(unperm_hd)]

        layers = _stack(
            [
                {
                    "attn_norm": self._vec(f"blk.{i}.attn_norm.weight"),
                    "q_norm": norm(f"blk.{i}.attn_q_norm.weight"),
                    "k_norm": norm(f"blk.{i}.attn_k_norm.weight"),
                    "ffn_norm": self._vec(f"blk.{i}.ffn_norm.weight"),
                }
                for i in range(L)
            ]
        )
        groups = {
            "qkv": (["blk.{i}.attn_q.weight", "blk.{i}.attn_k.weight", "blk.{i}.attn_v.weight"],
                    [unperm_q, unperm_k, None]),
            "o": (["blk.{i}.attn_output.weight"], None),
            "gateup": (["blk.{i}.ffn_gate.weight", "blk.{i}.ffn_up.weight"], None),
            "down": (["blk.{i}.ffn_down.weight"], None),
        }
        quantized = self._quantized(
            ["token_embd.weight"] + [f"blk.{i}.{n}" for i in range(L) for n in DECODER_PROJ_NAMES]
        )
        for key, (fmts, perms) in groups.items():
            if quantized:
                layers[key] = self._fill_stacked(fmts, L, perms)
                continue
            per_layer = []
            for i in range(L):
                parts = []
                for j, fmt in enumerate(fmts):
                    p = self._linear(t[fmt.format(i=i)])
                    perm = perms[j] if perms else None
                    if perm is not None:
                        p = _permute_out_rows(p, torch.from_numpy(perm))
                    parts.append(p)
                per_layer.append(_fuse_linears(parts))
            layers[key] = _stack(per_layer)
        params = {
            "embed": self._embedding(t["token_embd.weight"]),
            "layers": layers,
            "final_norm": self._vec("output_norm.weight"),
        }
        if "output.weight" in t and not cfg.tie_word_embeddings:
            params["lm_head"] = self._linear(t["output.weight"])
        return params

    def _load_encoder(self) -> Dict:
        cfg = self.config.audio
        t = self._tensors
        L = cfg.block_count

        def wb(name: str) -> Dict:
            return {"w": self._vec(f"aenc.{name}.weight"), "b": self._vec(f"aenc.{name}.bias")}

        def linear(name: str, bias: bool = True) -> Dict:
            return self._linear(t[f"aenc.{name}.weight"], t.get(f"aenc.{name}.bias") if bias else None)

        layers = _stack([{"attn_norm": wb(f"blk.{i}.attn_norm"), "ffn_norm": wb(f"blk.{i}.ffn_norm")} for i in range(L)])
        quantized = self._quantized(
            [f"aenc.blk.{i}.{n}.weight" for i in range(L) for n in ENCODER_LINEARS.values()]
        )
        for key, gname in ENCODER_LINEARS.items():
            if quantized:
                d = self._fill_stacked([f"aenc.blk.{{i}}.{gname}.weight"], L)
                if t.get(f"aenc.blk.0.{gname}.bias") is not None:
                    d["b"] = torch.stack([self._vec(f"aenc.blk.{i}.{gname}.bias") for i in range(L)])
            else:
                d = _stack([linear(f"blk.{i}.{gname}") for i in range(L)])
            layers[key] = d
        return {
            "conv1": wb("conv1"),
            "conv2": wb("conv2"),
            "conv3": wb("conv3"),
            "conv_out": linear("conv_out", bias=False),
            "layers": layers,
            "ln_post": wb("ln_post"),
            "proj1": linear("proj1"),
            "proj2": linear("proj2"),
            "pos_embd": torch.from_numpy(sinusoid_positions(cfg.max_source_positions, cfg.d_model)),
        }

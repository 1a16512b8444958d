"""Qwen3-ASR weights from a seed, and the Q8_0 GGUF artifact the engine loads.

Every tensor is drawn on the device by its own ``torch.Generator``, seeded
from the configuration's ``weights_seed`` and the tensor's index, so the
writer and the plain reference draw the same numbers without either reading
the other's output. Q8_0 matrices are drawn as they are stored: int8 quants
uniform on [-127, 127] and one float16 scale per 32-wide block, no float32
detour. The embedding rows of the 256 byte tokens and of the special tokens
are drawn at 1/16 of the scale, so greedy decoding never emits them: every
served token then names itself in the reply's text (:func:`token_text`).

The artifact is written once per checkout to ``build/benchmark_torch/`` and
read by the engine's own loader; names, layouts and metadata are those of
the GGUF files the port serves.
"""

from __future__ import annotations

import dataclasses
import os
import re
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

Q8_BLOCK = 32
Q8_BLOCK_BYTES = 34  # float16 scale + 32 int8 quants
GGML_F32, GGML_Q8_0 = 0, 8
ALIGN = 32
UNIFORM_Q_STD = float(np.sqrt((127 * 128) / 3.0))  # std of the integers uniform on [-127, 127]
SMALL_ROW_SCALE = 1.0 / 16
TEMPLATE = "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n"
TOKEN_RE = re.compile(r"<(\d{6})>")


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The sizes of a configuration file, under the names the code uses."""

    vocab: int
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    rms_eps: float
    rope_theta: float
    context: int
    mels: int
    a_d: int
    a_layers: int
    a_heads: int
    a_ffn: int
    a_hidden: int
    a_out: int
    n_window: int
    n_window_infer: int
    a_positions: int
    ln_eps: float
    audio_id: int
    bos_id: int
    eos_id: int
    pad_id: int

    @property
    def chunk_frames(self) -> int:
        return 2 * self.n_window

    @property
    def tokens_per_chunk(self) -> int:
        return conv_out_len(self.chunk_frames)

    @property
    def chunks_per_window(self) -> int:
        return max(1, self.n_window_infer // self.chunk_frames)

    @property
    def freq_after_conv(self) -> int:
        return conv_out_len(self.mels)

    @property
    def qkv_dim(self) -> int:
        return (self.heads + 2 * self.kv_heads) * self.head_dim


def conv_out_len(n: int) -> int:
    for _ in range(3):
        n = (n + 1) // 2
    return n


def shapes(cfg: Dict) -> Shapes:
    a = cfg["audio"]
    return Shapes(
        vocab=cfg["vocab_size"], d=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"], kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        ffn=cfg["intermediate_size"], rms_eps=float(cfg["rms_norm_eps"]), rope_theta=float(cfg["rope_theta"]),
        context=cfg["max_position_embeddings"], mels=a["num_mel_bins"], a_d=a["d_model"],
        a_layers=a["encoder_layers"], a_heads=a["encoder_attention_heads"], a_ffn=a["encoder_ffn_dim"],
        a_hidden=a["downsample_hidden_size"], a_out=a["output_dim"], n_window=a["n_window"],
        n_window_infer=a["n_window_infer"], a_positions=a["max_source_positions"], ln_eps=float(a["layer_norm_eps"]),
        audio_id=cfg["audio_token_id"], bos_id=cfg["bos_token_id"], eos_id=cfg["eos_token_id"],
        pad_id=cfg["pad_token_id"],
    )


def special_ids(s: Shapes) -> List[int]:
    return [s.pad_id, s.bos_id, s.eos_id, s.audio_id]


# ---------------------------------------------------------------------------
# the tensors: (name, shape, kind, std), in a fixed order


def tensor_specs(s: Shapes) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every tensor of the artifact. ``kind``: ``q8`` (a matrix [out, in]),
    ``norm`` (1 + std * N), ``bias`` (std * N) or ``dense`` (std * N)."""
    specs = [("token_embd.weight", (s.vocab, s.d), "q8", 0.05), ("output_norm.weight", (s.d,), "norm", 0.05)]
    q, kv = s.heads * s.head_dim, s.kv_heads * s.head_dim
    for i in range(s.layers):
        p = f"blk.{i}."
        specs += [
            (p + "attn_norm.weight", (s.d,), "norm", 0.05),
            (p + "attn_q.weight", (q, s.d), "q8", s.d ** -0.5),
            (p + "attn_k.weight", (kv, s.d), "q8", s.d ** -0.5),
            (p + "attn_v.weight", (kv, s.d), "q8", s.d ** -0.5),
            (p + "attn_output.weight", (s.d, q), "q8", q ** -0.5),
            (p + "attn_q_norm.weight", (s.head_dim,), "norm", 0.05),
            (p + "attn_k_norm.weight", (s.head_dim,), "norm", 0.05),
            (p + "ffn_norm.weight", (s.d,), "norm", 0.05),
            (p + "ffn_gate.weight", (s.ffn, s.d), "q8", s.d ** -0.5),
            (p + "ffn_up.weight", (s.ffn, s.d), "q8", s.d ** -0.5),
            (p + "ffn_down.weight", (s.d, s.ffn), "q8", s.ffn ** -0.5),
        ]
    h, ad = s.a_hidden, s.a_d
    specs += [
        ("aenc.conv1.weight", (h, 1, 3, 3), "dense", 0.2),
        ("aenc.conv1.bias", (h,), "bias", 0.02),
        ("aenc.conv2.weight", (h, h, 3, 3), "dense", 0.2 / np.sqrt(h)),
        ("aenc.conv2.bias", (h,), "bias", 0.02),
        ("aenc.conv3.weight", (h, h, 3, 3), "dense", 0.2 / np.sqrt(h)),
        ("aenc.conv3.bias", (h,), "bias", 0.02),
        ("aenc.conv_out.weight", (ad, h * s.freq_after_conv), "q8", (h * s.freq_after_conv) ** -0.5),
    ]
    for i in range(s.a_layers):
        p = f"aenc.blk.{i}."
        specs += [(p + "attn_norm.weight", (ad,), "norm", 0.05), (p + "attn_norm.bias", (ad,), "bias", 0.02)]
        for name in ("attn_q", "attn_k", "attn_v", "attn_output"):
            specs += [(p + name + ".weight", (ad, ad), "q8", ad ** -0.5), (p + name + ".bias", (ad,), "bias", 0.02)]
        specs += [
            (p + "ffn_norm.weight", (ad,), "norm", 0.05), (p + "ffn_norm.bias", (ad,), "bias", 0.02),
            (p + "ffn_up.weight", (s.a_ffn, ad), "q8", ad ** -0.5), (p + "ffn_up.bias", (s.a_ffn,), "bias", 0.02),
            (p + "ffn_down.weight", (ad, s.a_ffn), "q8", s.a_ffn ** -0.5), (p + "ffn_down.bias", (ad,), "bias", 0.02),
        ]
    specs += [
        ("aenc.ln_post.weight", (ad,), "norm", 0.05), ("aenc.ln_post.bias", (ad,), "bias", 0.02),
        ("aenc.proj1.weight", (ad, ad), "q8", ad ** -0.5), ("aenc.proj1.bias", (ad,), "bias", 0.02),
        ("aenc.proj2.weight", (s.a_out, ad), "q8", ad ** -0.5), ("aenc.proj2.bias", (s.a_out,), "bias", 0.02),
    ]
    return specs


def _generator(weights_seed: int, index: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(weights_seed) * 1_000_003 + index) % (2**63 - 1))
    return gen


def draw(s: Shapes, weights_seed: int, index: int, spec, device):
    """The tensor ``spec`` (the ``index``-th of :func:`tensor_specs`) on
    ``device``: ``(int8 quants, float16 scales)`` for ``q8``, float32 else."""
    name, shape, kind, std = spec
    gen = _generator(weights_seed, index, device)
    if kind == "q8":
        out_f, in_f = shape
        quants = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
        jitter = 0.75 + 0.5 * torch.rand((out_f, in_f // Q8_BLOCK), generator=gen, device=device)
        scales = jitter * (std / UNIFORM_Q_STD)
        if name == "token_embd.weight":
            small = torch.tensor(list(range(256)) + special_ids(s), device=device)
            scales[small] *= SMALL_ROW_SCALE
        return quants, scales.to(torch.float16)
    noise = torch.randn(shape, generator=gen, device=device) * std
    return noise + 1.0 if kind == "norm" else noise


def dequantize(quants: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Q8_0 as the format defines it: quant times its block's float16 scale, in float32."""
    out_f, in_f = quants.shape
    w = quants.float().reshape(out_f, in_f // Q8_BLOCK, Q8_BLOCK) * scales.float()[..., None]
    return w.reshape(out_f, in_f)


def named(s: Shapes, weights_seed: int, device, names) -> Dict[str, torch.Tensor]:
    """Only the tensors ``names``, float32 (Q8 dequantized), drawn on ``device``."""
    want = set(names)
    out = {}
    for index, spec in enumerate(tensor_specs(s)):
        if spec[0] in want:
            t = draw(s, weights_seed, index, spec, device)
            out[spec[0]] = dequantize(*t) if spec[2] == "q8" else t
    return out


# ---------------------------------------------------------------------------
# vocabulary: byte tokens, self-naming fillers, the specials


def token_text(token_id: int) -> str:
    return f"<{token_id:06d}>"


def byte_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → printable character table (byte-level BPE)."""
    printable = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1))
    mapping = {b: chr(b) for b in printable}
    fill = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + fill)
            fill += 1
    return mapping


def vocabulary(s: Shapes) -> Tuple[List[str], List[int]]:
    b2u = byte_to_unicode()
    tokens = [b2u[b] for b in range(256)] + [token_text(i) for i in range(256, s.vocab)]
    types = [1] * s.vocab
    for tid, text in ((s.pad_id, "<|endoftext|>"), (s.bos_id, "<|im_start|>"), (s.eos_id, "<|im_end|>"),
                      (s.audio_id, "<|audio_pad|>")):
        tokens[tid] = text
        types[tid] = 3
    return tokens, types


def prompt_ids(s: Shapes, n_audio: int) -> List[int]:
    """The prompt as :data:`TEMPLATE` tokenizes with this vocabulary: the
    specials as themselves, every other byte as its byte token."""
    return ([s.bos_id] + list(b"user\n") + [s.audio_id] * n_audio + [s.eos_id] + list(b"\n") + [s.bos_id]
            + list(b"assistant\n"))


PREFIX_LEN = 1 + len(b"user\n")
SUFFIX_LEN = 1 + len(b"\n") + 1 + len(b"assistant\n")


def parse_tokens(text: str):
    """The served token ids that a reply's text names, or ``None`` where the
    text is not a run of :func:`token_text` pieces."""
    ids = [int(m) for m in TOKEN_RE.findall(text)]
    return ids if "".join(token_text(i) for i in ids) == text else None


# ---------------------------------------------------------------------------
# GGUF


def _str(x: str) -> bytes:
    raw = x.encode("utf-8")
    return struct.pack("<Q", len(raw)) + raw


def _kv(key: str, value) -> bytes:
    out = _str(key)
    if isinstance(value, bool):
        return out + struct.pack("<IB", 7, int(value))
    if isinstance(value, int):
        return out + struct.pack("<Ii", 5, value)
    if isinstance(value, float):
        return out + struct.pack("<Id", 12, value)
    if isinstance(value, str):
        return out + struct.pack("<I", 8) + _str(value)
    if value and isinstance(value[0], int):
        return out + struct.pack("<IIQ", 9, 5, len(value)) + np.asarray(value, "<i4").tobytes()
    return out + struct.pack("<IIQ", 9, 8, len(value)) + b"".join(_str(v) for v in value)


def metadata(s: Shapes) -> Dict[str, object]:
    a = "qwen3asr."
    tokens, types = vocabulary(s)
    return {
        "general.architecture": "qwen3asr", "general.name": "qwen3-asr-benchmark",
        a + "vocab_size": s.vocab, a + "embedding_length": s.d, a + "block_count": s.layers,
        a + "feed_forward_length": s.ffn, a + "attention.head_count": s.heads,
        a + "attention.head_count_kv": s.kv_heads, a + "attention.key_length": s.head_dim,
        a + "attention.layer_norm_rms_epsilon": s.rms_eps, a + "rope.freq_base": s.rope_theta,
        a + "context_length": s.context, a + "tie_word_embeddings": True,
        a + "audio.num_mel_bins": s.mels, a + "audio.d_model": s.a_d, a + "audio.block_count": s.a_layers,
        a + "audio.head_count": s.a_heads, a + "audio.feed_forward_length": s.a_ffn,
        a + "audio.downsample_hidden_size": s.a_hidden, a + "audio.output_dim": s.a_out,
        a + "audio.n_window": s.n_window, a + "audio.n_window_infer": s.n_window_infer,
        a + "audio.max_source_positions": s.a_positions, a + "audio.layer_norm_epsilon": s.ln_eps,
        a + "audio_token_id": s.audio_id, a + "bos_token_id": s.bos_id, a + "eos_token_id": s.eos_id,
        a + "pad_token_id": s.pad_id,
        "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types, "tokenizer.ggml.merges": [],
        "tokenizer.chat_template": TEMPLATE,
    }


def _nbytes(shape, kind) -> int:
    n = int(np.prod(shape))
    return n // Q8_BLOCK * Q8_BLOCK_BYTES if kind == "q8" else n * 4


def _payload(t, kind) -> bytes:
    if kind == "q8":
        quants, scales = t
        blocks = torch.cat([scales.reshape(-1, 1).view(torch.uint8).reshape(-1, 2),
                            quants.reshape(-1, Q8_BLOCK).view(torch.uint8)], dim=1)
        return blocks.cpu().numpy().tobytes()
    return t.float().cpu().numpy().astype("<f4").tobytes()


def write(path: str, s: Shapes, weights_seed: int, device) -> None:
    """Write the artifact to ``path`` (through a side file renamed at the end)."""
    specs = tensor_specs(s)
    meta = metadata(s)
    head = bytearray(struct.pack("<IIQQ", 0x46554747, 3, len(specs), len(meta) + 1))
    head += _str("general.alignment") + struct.pack("<II", 4, ALIGN)
    for key, value in meta.items():
        head += _kv(key, value)
    offset = 0
    for name, shape, kind, _std in specs:
        ne = tuple(reversed(shape))
        head += _str(name) + struct.pack("<I", len(ne)) + b"".join(struct.pack("<Q", d) for d in ne)
        head += struct.pack("<IQ", GGML_Q8_0 if kind == "q8" else GGML_F32, offset)
        offset += -(-_nbytes(shape, kind) // ALIGN) * ALIGN
    os.makedirs(os.path.dirname(path), exist_ok=True)
    side = f"{path}.{os.getpid()}.part"
    with open(side, "wb") as f:
        f.write(head)
        f.write(b"\0" * (-len(head) % ALIGN))
        for index, spec in enumerate(specs):
            data = _payload(draw(s, weights_seed, index, spec, device), spec[2])
            f.write(data)
            f.write(b"\0" * (-len(data) % ALIGN))
    os.replace(side, path)


def ensure(root: str, config_name: str, cfg: Dict, device) -> str:
    """The configuration's artifact under ``root/build/benchmark_torch/``,
    written on the first call in a checkout."""
    path = os.path.join(root, "build", "benchmark_torch", f"{config_name}-w{cfg['weights_seed']}.gguf")
    if not os.path.isfile(path):
        write(path, shapes(cfg), cfg["weights_seed"], device)
    return path

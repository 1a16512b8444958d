"""Weights from a seed, and the Q8_0 GGUF artifact the engine loads.

What every architecture shares lives here: the per-index seeded drawing,
the Q8_0 layout, the vocabulary and the prompt, the AuT audio tower's
tensors and sizes, and the GGUF writer. An architecture's module
(``archs/<arch>.py``) gives its decoder's sizes, tensors and metadata.

Every tensor is drawn on the device by its own ``torch.Generator``, seeded
from the configuration's ``weights_seed`` and the tensor's index, so the
writer and the plain reference draw the same numbers without either reading
the other's output. Q8_0 matrices are drawn as they are stored: int8 quants
uniform on [-127, 127] and one float16 scale per 32-wide block, no float32
detour. In a matrix whose rows are the vocabulary (kind ``q8_vocab``) the
rows of the 256 byte tokens and of the special tokens are drawn at 1/16 of
the scale, so greedy decoding never emits them: every served token then
names itself in the reply's text (:func:`token_text`).

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
    """The sizes every architecture shares, under the names the code uses:
    the vocabulary and its special ids, the decoder's width (the audio rows
    are spliced into its embeddings) and the AuT tower. An architecture's
    module extends it with its decoder's sizes."""

    vocab: int
    d: int
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


def conv_out_len(n: int) -> int:
    for _ in range(3):
        n = (n + 1) // 2
    return n


def shared_sizes(cfg: Dict) -> Dict[str, object]:
    """The :class:`Shapes` fields of a configuration file, as keyword arguments."""
    a = cfg["audio"]
    return dict(
        vocab=cfg["vocab_size"], d=cfg["hidden_size"], mels=a["num_mel_bins"], a_d=a["d_model"],
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


def is_q8(kind: str) -> bool:
    return kind in ("q8", "q8_vocab")


def specs(arch, s: Shapes) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every tensor of the artifact: the architecture's decoder, then the
    tower. ``kind``: ``q8`` (a matrix [out, in]), ``q8_vocab`` (one whose
    rows are the vocabulary), ``norm`` (1 + std * N), ``bias`` (std * N) or
    ``dense`` (std * N)."""
    return arch.tensor_specs(s) + tower_specs(s)


def tower_specs(s: Shapes) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """The AuT audio tower's tensors."""
    h, ad = s.a_hidden, s.a_d
    specs = [
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
    """The tensor ``spec`` (the ``index``-th of :func:`specs`) on ``device``:
    ``(int8 quants, float16 scales)`` for a Q8 kind, float32 else."""
    _name, shape, kind, std = spec
    gen = _generator(weights_seed, index, device)
    if is_q8(kind):
        out_f, in_f = shape
        quants = torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)
        jitter = 0.75 + 0.5 * torch.rand((out_f, in_f // Q8_BLOCK), generator=gen, device=device)
        scales = jitter * (std / UNIFORM_Q_STD)
        if kind == "q8_vocab":
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


def named(s: Shapes, all_specs, weights_seed: int, device, names) -> Dict[str, torch.Tensor]:
    """Only the tensors ``names`` of ``all_specs`` (:func:`specs`), float32
    (Q8 dequantized), drawn on ``device``."""
    want = set(names)
    out = {}
    for index, spec in enumerate(all_specs):
        if spec[0] in want:
            t = draw(s, weights_seed, index, spec, device)
            out[spec[0]] = dequantize(*t) if is_q8(spec[2]) else t
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


def shared_metadata(prefix: str, s: Shapes) -> Dict[str, object]:
    """The tower's and the special ids' keys under an architecture's ``prefix``."""
    a = prefix
    return {
        a + "audio.num_mel_bins": s.mels, a + "audio.d_model": s.a_d, a + "audio.block_count": s.a_layers,
        a + "audio.head_count": s.a_heads, a + "audio.feed_forward_length": s.a_ffn,
        a + "audio.downsample_hidden_size": s.a_hidden, a + "audio.output_dim": s.a_out,
        a + "audio.n_window": s.n_window, a + "audio.n_window_infer": s.n_window_infer,
        a + "audio.max_source_positions": s.a_positions, a + "audio.layer_norm_epsilon": s.ln_eps,
        a + "audio_token_id": s.audio_id, a + "bos_token_id": s.bos_id, a + "eos_token_id": s.eos_id,
        a + "pad_token_id": s.pad_id,
    }


def metadata(arch, s: Shapes) -> Dict[str, object]:
    """The architecture's keys, then the vocabulary's and the prompt's."""
    tokens, types = vocabulary(s)
    return {
        **arch.metadata(s),
        "tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types, "tokenizer.ggml.merges": [],
        "tokenizer.chat_template": TEMPLATE,
    }


def _nbytes(shape, kind) -> int:
    n = int(np.prod(shape))
    return n // Q8_BLOCK * Q8_BLOCK_BYTES if is_q8(kind) else n * 4


def _payload(t, kind) -> bytes:
    if is_q8(kind):
        quants, scales = t
        blocks = torch.cat([scales.reshape(-1, 1).view(torch.uint8).reshape(-1, 2),
                            quants.reshape(-1, Q8_BLOCK).view(torch.uint8)], dim=1)
        return blocks.cpu().numpy().tobytes()
    return t.float().cpu().numpy().astype("<f4").tobytes()


def write(path: str, arch, s: Shapes, weights_seed: int, device) -> None:
    """Write the artifact to ``path`` (through a side file renamed at the end)."""
    all_specs = specs(arch, s)
    meta = metadata(arch, s)
    head = bytearray(struct.pack("<IIQQ", 0x46554747, 3, len(all_specs), len(meta) + 1))
    head += _str("general.alignment") + struct.pack("<II", 4, ALIGN)
    for key, value in meta.items():
        head += _kv(key, value)
    offset = 0
    for name, shape, kind, _std in all_specs:
        ne = tuple(reversed(shape))
        head += _str(name) + struct.pack("<I", len(ne)) + b"".join(struct.pack("<Q", d) for d in ne)
        head += struct.pack("<IQ", GGML_Q8_0 if is_q8(kind) else GGML_F32, offset)
        offset += -(-_nbytes(shape, kind) // ALIGN) * ALIGN
    os.makedirs(os.path.dirname(path), exist_ok=True)
    side = f"{path}.{os.getpid()}.part"
    with open(side, "wb") as f:
        f.write(head)
        f.write(b"\0" * (-len(head) % ALIGN))
        for index, spec in enumerate(all_specs):
            data = _payload(draw(s, weights_seed, index, spec, device), spec[2])
            f.write(data)
            f.write(b"\0" * (-len(data) % ALIGN))
    os.replace(side, path)


def ensure(root: str, cell, device) -> str:
    """The cell's artifact under ``root/build/benchmark_torch/``, written by
    its configuration's architecture on the first call in a checkout."""
    cfg = cell.config
    path = os.path.join(root, "build", "benchmark_torch", f"{cell.config_name}-w{cfg['weights_seed']}.gguf")
    if not os.path.isfile(path):
        write(path, cell.arch, cell.arch.shapes(cfg), cfg["weights_seed"], device)
    return path

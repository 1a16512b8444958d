"""Byte-level BPE tokenizer driven by GGUF-embedded vocab/merges.

The port's copy of ``light_whisper_tpu/models/qwen3_asr/tokenizer.py``.

The reference never tokenizes in Python — transcribe.cpp detokenizes inside
the C++ runtime from the GGUF's ``tokenizer.ggml.*`` metadata. This is the
engine's equivalent: a self-contained Qwen2-style byte-level BPE
(GPT-2 byte↔unicode table, ranked merges, tiktoken-style pre-tokenization
regex, special tokens matched verbatim). Decode is the ASR hot path; encode
is only needed for the fixed prompt.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

try:
    import regex as _re

    _PRETOKENIZE = _re.compile(
        r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"""
        r"""| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
    )
except ImportError:  # pragma: no cover - regex ships with transformers
    _re = None
    _PRETOKENIZE = None

# GGUF token_type values (llama.cpp vocab conventions).
TOKEN_TYPE_NORMAL = 1
TOKEN_TYPE_UNKNOWN = 2
TOKEN_TYPE_CONTROL = 3
TOKEN_TYPE_USER_DEFINED = 4


@functools.lru_cache(maxsize=1)
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → printable-unicode mapping."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    fill = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + fill)
            fill += 1
    return mapping


@functools.lru_cache(maxsize=1)
def unicode_to_byte() -> Dict[str, int]:
    return {c: b for b, c in byte_to_unicode().items()}


class BPETokenizer:
    def __init__(
        self,
        tokens: Sequence[str],
        merges: Sequence[str],
        token_types: Optional[Sequence[int]] = None,
    ) -> None:
        self.tokens = list(tokens)
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self.merge_ranks: Dict[Tuple[str, str], int] = {}
        for rank, merge in enumerate(merges):
            left, _, right = merge.partition(" ")
            self.merge_ranks[(left, right)] = rank
        types = list(token_types) if token_types is not None else []
        self.special_tokens = {
            self.tokens[i]
            for i, t in enumerate(types)
            if t in (TOKEN_TYPE_CONTROL, TOKEN_TYPE_USER_DEFINED)
        }
        self._special_pattern = None
        if self.special_tokens and _re is not None:
            escaped = sorted(map(_re.escape, self.special_tokens), key=len, reverse=True)
            self._special_pattern = _re.compile("|".join(escaped))
        self._u2b = unicode_to_byte()
        self._b2u = byte_to_unicode()

    # -- decode ---------------------------------------------------------

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        u2b = self._u2b
        raw = bytearray()
        for token_id in ids:
            if token_id < 0 or token_id >= len(self.tokens):
                continue
            token = self.tokens[token_id]
            if token in self.special_tokens:
                if not skip_special:
                    raw += token.encode("utf-8")
                continue
            for ch in token:
                b = u2b.get(ch)
                if b is None:
                    raw += ch.encode("utf-8")
                else:
                    raw.append(b)
        return raw.decode("utf-8", errors="replace")

    # -- encode ---------------------------------------------------------

    def _bpe(self, piece: str) -> List[str]:
        parts = list(piece)
        if len(parts) < 2:
            return parts
        ranks = self.merge_ranks
        while True:
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                rank = ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_idx = i
            if best_rank is None:
                return parts
            parts[best_idx : best_idx + 2] = [parts[best_idx] + parts[best_idx + 1]]
            if len(parts) == 1:
                return parts

    def encode(self, text: str) -> List[int]:
        """Encode with special tokens matched verbatim (prompt assembly)."""
        segments: List[Tuple[str, bool]] = []
        if self._special_pattern is not None:
            cursor = 0
            for m in self._special_pattern.finditer(text):
                if m.start() > cursor:
                    segments.append((text[cursor : m.start()], False))
                segments.append((m.group(), True))
                cursor = m.end()
            if cursor < len(text):
                segments.append((text[cursor:], False))
        else:
            segments.append((text, False))

        ids: List[int] = []
        for segment, is_special in segments:
            if is_special:
                ids.append(self.token_to_id[segment])
                continue
            words = (
                [m.group() for m in _PRETOKENIZE.finditer(segment)]
                if _PRETOKENIZE is not None
                else [segment]
            )
            for word in words:
                mapped = "".join(self._b2u[b] for b in word.encode("utf-8"))
                for part in self._bpe(mapped):
                    token_id = self.token_to_id.get(part)
                    if token_id is None:
                        # Unmergeable byte fallback (present in Qwen vocabs).
                        for ch in part:
                            ids.append(self.token_to_id[ch])
                    else:
                        ids.append(token_id)
        return ids


def tokenizer_from_metadata(meta: Dict) -> BPETokenizer:
    tokens = meta.get("tokenizer.ggml.tokens")
    if tokens is None:
        raise ValueError("GGUF metadata has no tokenizer.ggml.tokens")
    merges = meta.get("tokenizer.ggml.merges", [])
    token_types = meta.get("tokenizer.ggml.token_type")
    return BPETokenizer(tokens, merges, token_types)

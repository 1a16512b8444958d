"""The work a request needs, from the configuration's shapes alone, and the
card's peaks to hold it against.

Peaks: one H100 SXM, NVIDIA's data sheet, dense, at its 700 W limit (the run
prints the card's own limit beside every share): 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s of HBM. Bytes count each input read once and each
output written once; FLOPs count 2 a multiply-add of the work the request
needs (its true audio, prompt and steps; no padding).
"""

from __future__ import annotations

from typing import Tuple

from harness.artifact import PREFIX_LEN, SUFFIX_LEN, Shapes, conv_out_len

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
HOP = 160


def audio_tokens(s: Shapes, samples: int) -> int:
    """Encoder output rows of ``samples`` of audio (the mel frames' chunks)."""
    full, tail = divmod(samples // HOP, s.chunk_frames)
    return full * s.tokens_per_chunk + (conv_out_len(tail) if tail else 0)


def prompt_len(s: Shapes, samples: int) -> int:
    return PREFIX_LEN + audio_tokens(s, samples) + SUFFIX_LEN


# -- FLOPs -------------------------------------------------------------------


def _decoder_row_flops(s: Shapes) -> int:
    q = s.heads * s.head_dim
    return 2 * s.layers * (s.d * s.qkv_dim + q * s.d + s.d * 2 * s.ffn + s.ffn * s.d)


def encoder_flops(s: Shapes, samples: int) -> int:
    frames = samples // HOP
    chunks = -(-frames // s.chunk_frames)
    h, m, t = s.a_hidden, s.mels, s.chunk_frames
    convs = 0
    cin = 1
    for _ in range(3):
        m, t = (m + 1) // 2, (t + 1) // 2
        convs += 2 * 9 * cin * h * m * t
        cin = h
    n = audio_tokens(s, samples)
    window = s.tokens_per_chunk * s.chunks_per_window
    sq = sum(min(window, n - w) ** 2 for w in range(0, n, window))
    layer = 2 * n * (4 * s.a_d * s.a_d + 2 * s.a_d * s.a_ffn) + 4 * s.a_d * sq
    return (chunks * convs + 2 * n * h * s.freq_after_conv * s.a_d + s.a_layers * layer
            + 2 * n * (s.a_d * s.a_d + s.a_d * s.a_out))


def request_flops(s: Shapes, samples: int, tokens: int) -> int:
    """Encoder, prefill and ``tokens - 1`` decode steps (the last token is
    never fed back), each row with its causal attention, plus the logits
    head once a token."""
    p = prompt_len(s, samples)
    att = 4 * s.layers * s.heads * s.head_dim
    rows = p + max(0, tokens - 1)
    keys = rows * (rows + 1) // 2  # row t sees t + 1 keys
    head = 2 * s.d * s.vocab * tokens
    return encoder_flops(s, samples) + rows * _decoder_row_flops(s) + att * keys + head


# -- bytes of the decode kernels ----------------------------------------------


def _q8_bytes(n: int, k: int) -> int:
    return n * k + n * (k // 32) * 2  # int8 quants, 2-byte scales


def gemv_step_bytes(s: Shapes) -> Tuple[int, int]:
    """(weight bytes, bytes a row) of one decode forward's Q8 GEMVs: per
    layer qkv, o, gate-up and down, then the logits head. A row reads its
    input in bf16 once a projection and writes its float32 output."""
    q = s.heads * s.head_dim
    mats = [(s.qkv_dim, s.d), (s.d, q), (2 * s.ffn, s.d), (s.d, s.ffn)]
    weights = s.layers * sum(_q8_bytes(n, k) for n, k in mats) + _q8_bytes(s.vocab, s.d)
    per_row = s.layers * sum(2 * k + 4 * n for n, k in mats) + 2 * s.d + 4 * s.vocab
    return weights, per_row


def head_bytes(s: Shapes) -> Tuple[int, int]:
    """(weight bytes, bytes a row) of the logits head alone."""
    return _q8_bytes(s.vocab, s.d), 2 * s.d + 4 * s.vocab


def decode_attention_bytes(s: Shapes, prompt: int, steps: int) -> int:
    """K and V (bf16) that ``steps`` decode steps read after a prompt of
    ``prompt`` rows: step j attends prompt + j + 1 positions in every layer."""
    positions = steps * (prompt + 1) + steps * (steps - 1) // 2
    return 2 * s.layers * s.kv_heads * s.head_dim * 2 * positions


def gemv_launches(s: Shapes, forwards: int, prefills: int) -> int:
    """Q8 launches at T <= 8 rows: four a layer and the head each decode
    forward, and the head once a prefill (its first token)."""
    return forwards * (4 * s.layers + 1) + prefills

"""The work a request needs, from the configuration's shapes alone, and the
card's peaks to hold it against: what every architecture shares (the audio
tower, the prompt). An architecture's module (``archs/<arch>.py``) counts
its decoder's FLOPs, the bytes its decode kernels read and their launches.

Peaks: one H100 SXM, NVIDIA's data sheet, dense, at its 700 W limit (the run
prints the card's own limit beside every share): 989 TFLOP/s bf16 on the
tensor cores, 3.35 TB/s of HBM. Bytes count each input read once and each
output written once; FLOPs count 2 a multiply-add of the work the request
needs (its true audio, prompt and steps; no padding).
"""

from __future__ import annotations

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


# -- launches and bytes ---------------------------------------------------------


def encoder_launches(s: Shapes) -> int:
    """Q8 launches of the tower a prefill: conv_out, six linears a layer, proj1, proj2."""
    return 3 + 6 * s.a_layers


def q8_bytes(n: int, k: int) -> int:
    """Bytes of an [n, k] Q8_0 matrix: int8 quants, a 2-byte scale a block of 32."""
    return n * k + n * (k // 32) * 2

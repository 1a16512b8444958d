"""Host-side audio ingestion: inline PCM / WAV decode and resampling.

The port's copy of the parts of ``light_whisper_tpu/audio/pcm.py`` that the
engine server and the recording stack call. Behavioral parity targets in the
reference app:

- inline payload decode  → ``server_common.py:145-187`` (``decode_inline_audio``)
- linear-interp resample → ``qwen3_asr_server.py:230-243`` (``_resample``)
- capture-delta resample → ``resample.rs:130-159`` (``StreamingResampler``)
- file loading           → ``qwen3_asr_server.py:256-267`` (soundfile + channel mean)
- WAV encode             → ``audio_service/wav.rs`` (``encode_wav_mono_s16``)

These run on the host (numpy) and hand the model 16 kHz float32 mono.
"""

from __future__ import annotations

import base64
import binascii
import io
import struct
import wave
from typing import Optional, Tuple, Union

import numpy as np

TARGET_SAMPLE_RATE = 16_000


def _inline_pcm16(payload: bytes, sample_rate: Optional[int]) -> Tuple[np.ndarray, float]:
    if not sample_rate or sample_rate <= 0:
        raise ValueError("PCM 内存音频缺少有效采样率")
    if len(payload) & 1:
        raise ValueError("PCM s16le 数据字节数必须为偶数")
    pcm = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
    return pcm, pcm.size / float(sample_rate)


def _inline_wav(payload: bytes, sample_rate: Optional[int]) -> Tuple[io.BytesIO, float]:
    # Duration comes from the header alone; a malformed header degrades the
    # duration to 0 but still hands the blob to the backend.
    duration = 0.0
    try:
        with wave.open(io.BytesIO(payload), "rb") as header:
            if header.getframerate() > 0:
                duration = header.getnframes() / float(header.getframerate())
    except Exception:
        pass
    return io.BytesIO(payload), duration


_INLINE_DECODERS = {
    "pcm_s16le": _inline_pcm16,
    "wav": _inline_wav,
}


def decode_inline_audio(
    audio_base64: str,
    audio_format: Optional[str],
    sample_rate: Optional[int],
) -> Tuple[Union[np.ndarray, io.BytesIO], float]:
    """Decode a base64 inline payload into audio + duration (seconds).

    ``pcm_s16le`` yields float32 samples scaled by 1/32768; ``wav`` yields a
    BytesIO with a header-derived duration. The Chinese error strings are
    wire contract: the reference's Rust client recognizes them to decide
    transport fallback (``funasr_service.rs:1233-1248``).
    """
    if not audio_base64:
        raise ValueError("缺少内存音频数据")
    try:
        payload = base64.b64decode(audio_base64, validate=True)
    except (ValueError, binascii.Error) as exc:
        raise ValueError(f"音频 base64 解码失败: {exc}") from exc

    fmt = (audio_format or "pcm_s16le").lower()
    decode = _INLINE_DECODERS.get(fmt)
    if decode is None:
        raise ValueError(f"不支持的内存音频格式: {fmt}")
    return decode(payload, sample_rate)


def resample_linear(audio: np.ndarray, source_rate: int, target_rate: int = TARGET_SAMPLE_RATE) -> np.ndarray:
    """Linear-interpolation resample, numerically matching the reference.

    The reference maps ``target_length`` points over ``linspace(0, len-1)`` and
    interpolates (``qwen3_asr_server.py:230-243``); transcripts are sensitive
    to the frontend, so the exact same sample grid is used here.
    """
    audio = np.asarray(audio)
    if source_rate == target_rate:
        return audio.astype(np.float32, copy=False)
    target_length = int(round(len(audio) * target_rate / source_rate))
    if target_length <= 0:
        return np.empty(0, dtype=np.float32)
    positions = np.linspace(0, max(0, len(audio) - 1), target_length)
    return np.interp(
        positions,
        np.arange(len(audio), dtype=np.float64),
        audio,
    ).astype(np.float32)


class StreamingResampler:
    """Phase-continuous linear resampler for capture deltas.

    The recording pump resamples each ring delta as it arrives; restarting
    :func:`resample_linear`'s endpoint-pinned grid a delta would stretch every
    chunk slightly and sample each seam twice. This keeps a fractional
    source-position cursor across deltas: the output grid is
    ``k * source_rate / target_rate`` over the whole stream, however it was
    chunked (the app's stateful interim resampler, ``resample.rs:130-159``).
    """

    def __init__(self, source_rate: int, target_rate: int = TARGET_SAMPLE_RATE) -> None:
        if source_rate <= 0 or target_rate <= 0:
            raise ValueError(f"invalid sample rate: {source_rate} -> {target_rate}")
        self.source_rate = int(source_rate)
        self.target_rate = int(target_rate)
        self._step = self.source_rate / self.target_rate
        self._next_pos = 0.0  # absolute source position of the next output
        self._consumed = 0  # source samples pushed so far
        self._prev: Optional[np.float32] = None  # the last source sample seen

    def push(self, delta: np.ndarray) -> np.ndarray:
        """Resample the next chunk of the stream; returns float32 output."""
        delta = np.asarray(delta, dtype=np.float32)
        if self.source_rate == self.target_rate:
            self._consumed += len(delta)
            return delta
        if len(delta) == 0:
            return np.empty(0, dtype=np.float32)
        # local buffer = [previous chunk's last sample] + delta, so that an
        # output between the two chunks interpolates across the seam
        if self._prev is not None:
            buf = np.concatenate(([self._prev], delta))
            start = self._consumed - 1
        else:
            buf = delta
            start = self._consumed
        last_pos = self._consumed + len(delta) - 1
        out_positions = []
        pos = self._next_pos
        while pos <= last_pos:
            out_positions.append(pos)
            pos += self._step
        self._next_pos = pos
        self._consumed += len(delta)
        self._prev = buf[-1]
        if not out_positions:
            return np.empty(0, dtype=np.float32)
        local = np.asarray(out_positions, dtype=np.float64) - start
        return np.interp(local, np.arange(len(buf), dtype=np.float64), buf).astype(np.float32)


def read_audio_file_mono_f32(path: str) -> Tuple[np.ndarray, int]:
    """Read an audio file to (float32 mono samples, source_rate).

    Supports WAV PCM 16/24/32-bit and IEEE float32 — the formats the shell
    actually writes (``audio_service/wav.rs`` emits mono 16-bit PCM). Multi-
    channel audio is averaged to mono like the reference's soundfile path.
    """
    with open(path, "rb") as f:
        header = f.read(12)
    if len(header) >= 12 and header[:4] == b"RIFF" and header[8:12] == b"WAVE":
        return _read_wav_mono_f32(path)
    raise ValueError(f"不支持的音频文件格式: {path}")


def _read_wav_mono_f32(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        data = f.read()

    # Walk RIFF chunks explicitly: the stdlib wave module rejects float WAVs
    # and non-canonical chunk layouts that soundfile accepted.
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAVE file")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        chunk_size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            payload = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or payload is None:
        raise ValueError("WAV missing fmt/data chunks")

    audio_format, channels, rate, _byte_rate, _block_align, bits = fmt
    if audio_format == 0xFFFE and len(payload) > 0:
        # WAVE_FORMAT_EXTENSIBLE: sub-format GUID starts with the format tag.
        audio_format = 1 if bits in (16, 24, 32) else 3

    if audio_format == 1 and bits == 16:
        samples = np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 1 and bits == 32:
        samples = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_format == 1 and bits == 24:
        raw = np.frombuffer(payload, dtype=np.uint8)
        raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
        as_int = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        as_int = np.where(as_int >= 1 << 23, as_int - (1 << 24), as_int)
        samples = as_int.astype(np.float32) / 8388608.0
    elif audio_format == 3 and bits == 32:
        samples = np.frombuffer(payload, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV encoding: format={audio_format} bits={bits}")

    if channels > 1:
        samples = samples[: len(samples) - len(samples) % channels]
        samples = samples.reshape(-1, channels).mean(axis=1, dtype=np.float32)
    return np.ascontiguousarray(samples, dtype=np.float32), rate


def encode_wav_mono_s16(samples_f32: np.ndarray, sample_rate: int) -> bytes:
    """Encode mono float32 samples to canonical 16-bit PCM WAV bytes."""
    pcm = np.clip(np.asarray(samples_f32) * 32768.0, -32768, 32767).astype("<i2")
    return encode_wav_mono_pcm16(pcm, sample_rate)


def encode_wav_mono_pcm16(samples_i16: np.ndarray, sample_rate: int) -> bytes:
    """Encode mono int16 samples to WAV bytes, bit-exact (no f32 round trip)."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.asarray(samples_i16, dtype="<i2").tobytes())
    return buf.getvalue()

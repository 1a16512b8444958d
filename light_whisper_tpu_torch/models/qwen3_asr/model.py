"""End-to-end Qwen3-ASR transcriber (counterpart of ``models/qwen3_asr/model.py``).

audio → log-mel → AuT encoder → prompt splice → decoder prefill → greedy
decode → text. Three shape rules of the reference are kept because they are
semantics, not compiler needs:

- audio is bucketed in 0.5 s steps (then powers of two): the reflect pad at
  the true end and the mel frame count depend on the bucket;
- the prompt is end-padded to a 64-token bucket (causality keeps the padding
  inert; the first token comes from the true last row);
- the KV cache capacity is a power of two from 1024.

The reference's load-overlapped shadow warmup and its device mesh work around
XLA compile walls and the TPU relay; they are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List

import numpy as np
import torch

from light_whisper_tpu.models.qwen3_asr.config import Qwen3ASRConfig, conv_output_length
from light_whisper_tpu.models.qwen3_asr.prompt import resolve_prompt_ids
from light_whisper_tpu_torch.audio import mel as wmel
from light_whisper_tpu_torch.audio.mel import SAMPLE_RATE
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode_chunks
from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights

PROMPT_BUCKET = 64
_LANG_TOKEN = re.compile(r"^<\|([a-z]{2,3}(?:-[a-z]+)?)\|>$")

_FINE_STEP = SAMPLE_RATE // 2
_FINE_MAX = 16 * SAMPLE_RATE


def bucket_audio_samples(n: int) -> int:
    if n <= _FINE_MAX:
        return max(_FINE_STEP, (n + _FINE_STEP - 1) // _FINE_STEP * _FINE_STEP)
    b = _FINE_MAX
    while b < n:
        b *= 2
    return b


def as_device_audio(audio: np.ndarray) -> np.ndarray:
    """int16 when the audio is exactly s16-representable (every pcm_s16le wire
    request), float32 otherwise; the mel front end scales int16 by 1/32768,
    which is bit-identical. ``LWT_AUDIO_INT16=0`` keeps float32."""
    audio = np.asarray(audio)
    if audio.dtype == np.int16:
        return audio
    if os.environ.get("LWT_AUDIO_INT16", "1") in ("", "0"):
        return np.asarray(audio, dtype=np.float32)
    audio = audio.astype(np.float32, copy=False)
    scaled = audio * np.float32(32768.0)  # exact: power-of-two scale
    rounded = np.rint(scaled)
    if audio.size == 0 or (
        np.array_equal(scaled, rounded) and scaled.min() >= -32768.0 and scaled.max() <= 32767.0
    ):
        return rounded.astype(np.int16)
    return audio


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is false")
    return device


@dataclasses.dataclass
class TranscriptionResult:
    text: str
    language: str
    tokens: List[int]


def _build_prompt_embeds(params: Dict, ids: torch.Tensor, audio_embeds: torch.Tensor, n_audio: int,
                         prefix_len: int, dtype: torch.dtype) -> torch.Tensor:
    """Token embeddings with audio rows spliced in at [prefix, prefix + n_audio)."""
    embeds = dec.embed_tokens(params, ids).to(dtype)
    embeds[prefix_len : prefix_len + n_audio] = audio_embeds[:n_audio].to(dtype)
    return embeds


class Qwen3ASRModel:
    def __init__(
        self,
        gguf_path: str,
        device="cuda",
        max_new_tokens: int = 448,
        precise: bool = False,
    ) -> None:
        """``precise=True``: dense f32 weights, f32 compute and f32 KV cache."""
        self.device = resolve_device(device)
        weights = Qwen3ASRWeights(gguf_path, device=self.device, precise=precise)
        self.load_timings = dict(weights.load_timings)
        self.config: Qwen3ASRConfig = weights.config
        self.tokenizer = weights.tokenizer
        self.decoder_params = weights.decoder_params
        self.encoder_params = weights.encoder_params
        self.max_new_tokens = max_new_tokens
        self.cache_dtype = torch.float32 if precise else torch.bfloat16
        self.prefix_ids, self.suffix_ids = resolve_prompt_ids(
            weights.metadata.get("tokenizer.chat_template"),
            self.tokenizer,
            self.config.audio_token_id,
            context=os.environ.get("LWT_ASR_CONTEXT", ""),
        )
        # host wall of each decode step of the last transcribe (seconds)
        self.last_decode_step_s: List[float] = []

    def _cache_for(self, needed: int) -> dec.KVCache:
        capacity = 1024
        while capacity < needed:
            capacity *= 2
        capacity = min(capacity, self.config.decoder.context_length)
        if needed > capacity:
            raise ValueError(
                f"prompt+decode budget {needed} exceeds context {self.config.decoder.context_length}"
            )
        return dec.init_cache(self.config.decoder, capacity, self.cache_dtype, self.device)

    def _prepare(self, audio: np.ndarray):
        """Host-side request layout: ``(padded audio, n_audio, padded prompt ids,
        true prompt length, mel frames, encoder chunks)``."""
        audio = as_device_audio(np.asarray(audio).reshape(-1))
        bucket = bucket_audio_samples(len(audio))
        padded = np.zeros(bucket, dtype=audio.dtype)
        padded[: len(audio)] = audio
        n_audio = self._audio_tokens_for(len(audio))
        ids = self.prefix_ids + [self.config.audio_token_id] * n_audio + self.suffix_ids
        true_len = len(ids)
        ids_padded = np.full(_round_up(true_len, PROMPT_BUCKET), self.config.pad_token_id, dtype=np.int64)
        ids_padded[:true_len] = ids
        mel_frames = wmel.num_mel_frames(bucket)
        chunk = self.config.audio.chunk_frames
        num_chunks = max(1, (mel_frames + chunk - 1) // chunk)
        return padded, n_audio, ids_padded, true_len, mel_frames, num_chunks

    def _encode_and_prefill(self, padded, n_audio, ids_padded, true_len, mel_frames, num_chunks, cache):
        """log-mel → encoder → prompt splice → prefill; returns the logits of
        the true last prompt row and leaves ``cache.pos`` at ``true_len``."""
        waveform = torch.from_numpy(padded).to(self.device)
        mel, _clip_max = wmel.log_mel_with_max(waveform, mel_frames)
        chunk = self.config.audio.chunk_frames
        mel = torch.nn.functional.pad(mel, (0, 0, 0, num_chunks * chunk - mel.shape[0]))
        audio_embeds = encode_chunks(self.config.audio, self.encoder_params, mel, n_audio, num_chunks)
        dtype = dec.torch_dtype(self.config.decoder.compute_dtype)
        ids = torch.from_numpy(ids_padded).to(self.device)
        embeds = _build_prompt_embeds(self.decoder_params, ids, audio_embeds, n_audio,
                                      len(self.prefix_ids), dtype)
        hidden = dec.forward(self.config.decoder, self.decoder_params, embeds, cache)
        # the padded tail wrote K/V at positions >= true_len; decode overwrites
        # them before reading (causal masking keeps positions < true_len exact)
        cache.pos = true_len
        return dec.logits_for(self.config.decoder, self.decoder_params, hidden[true_len - 1][None])[0]

    @torch.no_grad()
    def transcribe(self, audio: np.ndarray) -> TranscriptionResult:
        """Greedy transcription of mono 16 kHz audio (float32 or int16)."""
        request = self._prepare(audio)
        cache = self._cache_for(len(request[2]) + self.max_new_tokens)
        logits = self._encode_and_prefill(*request, cache)
        self.last_decode_step_s = []
        generated = dec.decode_greedy(
            self.config.decoder,
            self.decoder_params,
            torch.argmax(logits),
            cache,
            self.config.eos_token_id,
            self.max_new_tokens,
            step_times=self.last_decode_step_s,
        )
        return self._parse_output(generated)

    @torch.no_grad()
    def teacher_forced_logits(self, audio: np.ndarray, tokens: List[int]) -> List[torch.Tensor]:
        """Logits after the prompt and after each of ``tokens`` fed in turn
        (``len(tokens) + 1`` rows of the padded vocab, f32 on the host). Used to
        read the top-2 gap where two implementations' greedy paths part."""
        request = self._prepare(audio)
        cache = self._cache_for(len(request[2]) + len(tokens) + 1)
        rows = [self._encode_and_prefill(*request, cache)]
        for tok in tokens:
            ids = torch.tensor([tok], device=self.device)
            hidden = dec.forward(self.config.decoder, self.decoder_params,
                                 dec.embed_tokens(self.decoder_params, ids), cache)
            rows.append(dec.logits_for(self.config.decoder, self.decoder_params, hidden)[0])
        return [r.float().cpu() for r in rows]

    def _parse_output(self, generated: List[int]) -> TranscriptionResult:
        language = "unknown"
        for token_id in generated[:4]:
            if 0 <= token_id < len(self.tokenizer.tokens):
                m = _LANG_TOKEN.match(self.tokenizer.tokens[token_id])
                if m:
                    language = m.group(1)
                    break
        text = self.tokenizer.decode(generated).strip()
        return TranscriptionResult(text=text, language=language, tokens=generated)

    def _audio_tokens_for(self, n_samples: int) -> int:
        true_frames = wmel.num_mel_frames(n_samples)
        chunk = self.config.audio.chunk_frames
        full_chunks, tail = divmod(true_frames, chunk)
        return full_chunks * self.config.audio.tokens_per_chunk + (
            conv_output_length(tail) if tail else 0
        )

    def warmup(self) -> None:
        """One transcribe of 1 s of s16-grid noise (the wire's int16 path)."""
        rng = np.random.default_rng(0)
        self.transcribe((rng.standard_normal(SAMPLE_RATE) * 0.002 * 32768.0).astype(np.int16))

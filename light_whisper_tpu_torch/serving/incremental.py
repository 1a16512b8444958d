"""Interim ticks with KV-prefix reuse (counterpart of ``serving/incremental.py``).

The app's interim loop re-sends the same growing recording every few hundred
milliseconds. Two facts make most of each tick reusable:

1. audio tokens are append-only while the window only grows: the 0.5 s audio
   buckets never change mel chunks that were already produced;
2. the encoder's attention windows are block-diagonal: the tokens of a
   *complete* window group (``window_tokens`` post-conv frames) are final
   once every mel frame they see is final.

A tick therefore rolls the session's KV cache back to ``prefix + stable``
audio tokens and prefills only the unstable audio tail, the suffix and the
previous tick's transcript as a draft, verified in the same pass: the draft is
accepted up to its first token that the model's argmax does not reproduce,
and the greedy loop continues from there. Two guards keep the result that of
a stateless ``transcribe`` of the window:

- the mel front end clamps every frame at ``clip_max - 8`` of the whole clip,
  so louder audio later moves earlier quiet frames: when the window's clip max
  grows past the one the cached prefix was computed under (by more than
  ``CLIP_MAX_EPS``), the tick is redone as a full prefill
  (``clip_guard_prefills``);
- the last mel frames read up to ``N_FFT/2`` samples past the audio's end, so
  the stable boundary (:meth:`IncrementalTranscriber._stable_boundary`) takes
  only window groups whose frames lie wholly inside the received samples.

What differs from the reference: ``KVCache.pos`` is a host int, so a tick
reads the draft verification's argmax window and the clip max in one device
sync after the segment prefill; the clip guard is checked there, before the
decode, where the reference defers it past its decode to save a round trip
(the results are the same). The logits of every segment row are computed, as
in the reference. The reference's device-resident audio buffer
(``_append_audio``, ``LWT_DEVICE_AUDIO_BUF``) hides relay latency and is not
ported: the window is copied to the device once a tick; ``warmup_ladder``
precompiles XLA programs and is not ported either.

On a tensor-parallel model (``Qwen3ASRModel(mesh=)``) the session's cache is
placed by ``model.place_cache`` and every forward takes the model's rank
widths and seams (``model.rank_config``, ``model.tp``, ``model.encoder_tp``);
every rank then runs the same tick, and nothing else here changes.

Paths compute the same function in different reduction orders, so a greedy
argmax may flip where the top-2 logits lie within ~1e-3 (the repo's tie band).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from light_whisper_tpu_torch.audio import mel as wmel
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode_chunks
from light_whisper_tpu_torch.models.qwen3_asr.model import (
    Qwen3ASRModel,
    TranscriptionResult,
    _round_up,
    as_device_audio,
    bucket_audio_samples,
)
from light_whisper_tpu_torch.runtime import tracing

SEGMENT_BUCKET = 64
INTERIM_MAX_NEW_TOKENS = 96
DRAFT_TOKENS = 64  # previous-tick transcript tokens verified per tick
# Allowed growth of the clip's mel max (log10 units) before the cached stable
# prefix counts as stale; anchored at the last full prefill. The clamp floor
# only touches frames 8 decades below the max, and 0.05 moves their normalised
# values by at most 0.0125, the order of the bf16 cache's own rounding.
CLIP_MAX_EPS = 0.05


def cache_capacity_for(needed: int) -> int:
    """KV capacity of a session: a power of two from 512 (the batched tick
    groups sessions by it and compares it with ``_cache_capacity``)."""
    capacity = 512
    while capacity < needed:
        capacity *= 2
    return capacity


def _segment_embeds(model: Qwen3ASRModel, audio_embeds: torch.Tensor, n_audio: int, stable: int,
                    draft: List[int], seg_bucket: int) -> torch.Tensor:
    """``[seg_bucket, D]`` rows: audio tokens ``stable..n_audio``, the suffix,
    the draft padded to ``DRAFT_TOKENS``, then the last of those repeated (the
    reference's clipped gather; causality keeps the padding inert)."""
    cfg = model.config
    dev = audio_embeds.device
    dtype = dec.torch_dtype(cfg.decoder.compute_dtype)
    draft_ids = list(draft) + [0] * (DRAFT_TOKENS - len(draft))
    token_ids = torch.tensor(list(model.suffix_ids) + draft_ids, dtype=torch.int64, device=dev)
    token_embeds = dec.embed_tokens(model.decoder_params, token_ids).to(dtype)
    idx = torch.arange(seg_bucket, device=dev)
    seg_audio = n_audio - stable
    audio_row = torch.clamp(stable + idx, 0, audio_embeds.shape[0] - 1)
    token_row = torch.clamp(idx - seg_audio, 0, token_ids.shape[0] - 1)
    return torch.where((idx < seg_audio)[:, None], audio_embeds.to(dtype)[audio_row], token_embeds[token_row])


def accept_draft(window: List[int], draft: List[int]) -> int:
    """Draft tokens accepted: ``window[i]`` is the model's argmax at the row
    that predicts draft position ``i``; acceptance stops at the first miss."""
    accepted = 0
    while accepted < len(draft) and draft[accepted] == window[accepted]:
        accepted += 1
    return accepted


def _encode_prefill_segment(model: Qwen3ASRModel, padded: np.ndarray, n_audio: int, stable: int,
                            draft: List[int], cache: dec.KVCache, num_chunks: int, mel_frames: int,
                            seg_bucket: int):
    """mel → encoder over the window → segment embeds (unstable audio tail,
    suffix, draft) → prefill from ``cache.pos`` (= prefix + stable) → argmax
    of every row. Returns ``(argmax window, clip max)`` on the host (one sync):
    the ``DRAFT_TOKENS + 1`` predictions from the row that predicts the first
    token on. The ``model.encode`` and ``model.prefill`` spans, the latter
    closed by that sync."""
    cfg = model.config
    with tracing.span("model.encode"):
        waveform = torch.from_numpy(padded).to(model.device)
        mel, clip_max = wmel.log_mel_with_max(waveform, mel_frames)
        mel = torch.nn.functional.pad(mel, (0, 0, 0, num_chunks * cfg.audio.chunk_frames - mel.shape[0]))
        audio_embeds = encode_chunks(model.rank_config.audio, model.encoder_params, mel, n_audio, num_chunks,
                                     model.encoder_tp)
    with tracing.span("model.prefill"):
        embeds = _segment_embeds(model, audio_embeds, n_audio, stable, draft, seg_bucket)
        hidden = dec.forward(model.rank_config.decoder, model.decoder_params, embeds, cache, model.tp)
        preds = torch.argmax(dec.logits_for(cfg.decoder, model.decoder_params, hidden), dim=-1)
        first_index = (n_audio - stable) + len(model.suffix_ids) - 1
        window = preds[first_index : first_index + DRAFT_TOKENS + 1].cpu().tolist()
    return window, float(clip_max)


class IncrementalTranscriber:
    """Streaming transcriber bound to one model and one persistent KV cache."""

    def __init__(self, model: Qwen3ASRModel, max_new_tokens: int = INTERIM_MAX_NEW_TOKENS):
        self.model = model
        self.max_new_tokens = max_new_tokens
        self._window_tokens = model.config.audio.window_tokens
        self._cache: Optional[dec.KVCache] = None
        self._cache_capacity = 0
        self._window_start: Optional[int] = None
        self._stable_tokens = 0
        self._clip_max: Optional[float] = None
        self._last_generated: List[int] = []
        self.full_prefills = 0
        self.incremental_prefills = 0
        self.clip_guard_prefills = 0
        self.draft_tokens_offered = 0
        self.draft_tokens_accepted = 0
        # host wall of each decode step of the last tick (seconds)
        self.last_decode_step_s: List[float] = []

    def reset(self) -> None:
        self._cache = None
        self._window_start = None
        self._stable_tokens = 0
        self._clip_max = None
        self._last_generated = []

    def _ensure_cache(self, needed: int) -> None:
        capacity = cache_capacity_for(needed)
        if self._cache is None or self._cache_capacity < capacity:
            cache = dec.init_cache(self.model.config.decoder, capacity, self.model.cache_dtype, self.model.device)
            # a tensor-parallel model keeps its block of the KV heads (no-op on
            # one device or on a stand-in model without the method)
            place = getattr(self.model, "place_cache", None)
            self._cache = place(cache) if place is not None else cache
            self._cache_capacity = capacity
            self._stable_tokens = -1  # force a full prefill

    def transcribe_window(self, window: np.ndarray, window_start_sample: int = 0) -> TranscriptionResult:
        try:
            with torch.no_grad():
                return self._transcribe_window(window, window_start_sample)
        except Exception:
            # a tick that failed part way leaves the cache half written: the
            # next tick starts from a fresh one
            self.reset()
            raise

    def _transcribe_window(self, window: np.ndarray, window_start_sample: int) -> TranscriptionResult:
        model = self.model
        cfg = model.config
        window = as_device_audio(np.asarray(window).reshape(-1))
        bucket = bucket_audio_samples(len(window))
        padded = np.zeros(bucket, dtype=window.dtype)
        padded[: len(window)] = window
        n_audio = model._audio_tokens_for(len(window))
        mel_frames = wmel.num_mel_frames(bucket)
        chunk = cfg.audio.chunk_frames
        num_chunks = max(1, (mel_frames + chunk - 1) // chunk)
        prefix_len = len(model.prefix_ids)
        suffix_len = len(model.suffix_ids)
        true_len = prefix_len + n_audio + suffix_len
        self._ensure_cache(true_len + DRAFT_TOKENS + self.max_new_tokens)
        cache = self._cache
        self.last_decode_step_s = []

        if self._window_start == window_start_sample and 0 <= self._stable_tokens <= n_audio:
            stable = self._stable_tokens
            draft = self._last_generated[:DRAFT_TOKENS]
            seg_bucket = _round_up(max(1, (n_audio - stable) + suffix_len + DRAFT_TOKENS), SEGMENT_BUCKET)
            cache.pos = prefix_len + stable
            preds, clip_max = _encode_prefill_segment(model, padded, n_audio, stable, draft, cache, num_chunks,
                                                      mel_frames, seg_bucket)
            if self._clip_max is not None and clip_max > self._clip_max + CLIP_MAX_EPS:
                # louder audio moved the mel clamp floor: the cached prefix was
                # computed under another normalisation; redo as a full prefill
                self.clip_guard_prefills += 1
            else:
                accepted = accept_draft(preds, draft)
                cache.pos = true_len + accepted
                first = torch.tensor(preds[accepted], device=model.device)
                tail = dec.decode_greedy(model.rank_config.decoder, model.decoder_params, first, cache,
                                         cfg.eos_token_id, self.max_new_tokens, step_times=self.last_decode_step_s,
                                         budget=self.max_new_tokens - accepted, tp=model.tp)
                self.incremental_prefills += 1
                self.draft_tokens_offered += len(draft)
                self.draft_tokens_accepted += accepted
                self._window_start = window_start_sample
                self._stable_tokens = self._stable_boundary(len(window), n_audio)
                self._last_generated = list(draft[:accepted]) + tail
                return model._parse_output(self._last_generated)

        # full prefill of prefix + audio + suffix, end-padded to SEGMENT_BUCKET
        ids = np.full(_round_up(true_len, SEGMENT_BUCKET), cfg.pad_token_id, dtype=np.int64)
        ids[:true_len] = model._prompt_ids(n_audio)
        cache.pos = 0
        logits, clip_max = model._encode_and_prefill(padded, n_audio, ids, true_len, mel_frames, num_chunks, cache)
        generated = dec.decode_greedy(model.rank_config.decoder, model.decoder_params, torch.argmax(logits), cache,
                                      cfg.eos_token_id, self.max_new_tokens, step_times=self.last_decode_step_s,
                                      tp=model.tp)
        self.full_prefills += 1
        self._window_start = window_start_sample
        # anchored at full prefills only: every cached row was computed at this
        # floor, so the guard bounds the drift against the stalest row
        self._clip_max = float(clip_max)
        self._stable_tokens = self._stable_boundary(len(window), n_audio)
        self._last_generated = generated
        return model._parse_output(generated)

    def _stable_boundary(self, n_samples: int, n_audio: int) -> int:
        """Audio tokens that can never change as the window grows in place:
        whole attention-window groups whose mel frames' receptive fields
        (``[i*HOP - N_FFT/2, i*HOP + N_FFT/2)``) lie inside ``n_samples``."""
        cfg = self.model.config.audio
        group_frames = cfg.chunk_frames * max(1, cfg.n_window_infer // cfg.chunk_frames)
        frames_final = min(n_samples // wmel.HOP, max(0, (n_samples - wmel.N_FFT // 2) // wmel.HOP + 1))
        wt = self._window_tokens
        return min((frames_final // group_frames) * wt, (n_audio // wt) * wt)

    def transcribe(self, audio: np.ndarray) -> TranscriptionResult:
        """``StreamingSession``'s duck type: the whole window, from sample 0."""
        return self.transcribe_window(audio, window_start_sample=0)

"""Batched interim ticks (counterpart of ``serving/incremental_batch.py``).

N dictation streams tick together: decode reads the weights once a step for
the batch, where N sequential ticks read them N times. :func:`tick_batch`
groups the streams:

- compatible EXTENDING sessions (same audio bucket, cache capacity, decode
  budget, model and audio dtype) run one batched segment tick: batched mel →
  batched encoder → ``forward_prefill_batch`` of every stream's segment (each
  padded to the group's longest, from its own rollback position) → per-stream
  draft verification → one batched greedy decode with per-stream budgets;
- compatible FRESH sessions run one batched full prefill and decode that
  primes their sessions;
- everything else runs the per-stream tick (:meth:`IncrementalTranscriber.
  transcribe_window`): lone streams, a clip-guard redo, a stream whose cache
  the group's segment length would overflow, and every stream of a batched
  run that raised.

The batched runners stack the streams' caches into a batch copy and write
session state back only after all device work has finished, so a failure
leaves every session as it was; it degrades the group to per-stream ticks,
counted in ``degrade_count`` (the server's ``batched_tick_degrades``) with its
cause in ``last_degrade_error``. The per-stream tick runs on the same device
with the same kernels.

The streams of a group are not padded to a bucketed batch size (the
reference's ``_bucket_b`` bounds XLA compiles). Results equal sequential
per-stream ticks up to argmax flips inside the ~1e-3 top-2 tie band (the
batched programs sum in other orders).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from light_whisper_tpu_torch.audio import mel as wmel
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode_chunks_batch
from light_whisper_tpu_torch.models.qwen3_asr.model import (
    _decode_greedy_batch,
    _round_up,
    as_device_audio,
    bucket_audio_samples,
    max_decode_batch,
)
from light_whisper_tpu_torch.runtime import tracing
from light_whisper_tpu_torch.serving.incremental import (
    CLIP_MAX_EPS,
    DRAFT_TOKENS,
    SEGMENT_BUCKET,
    IncrementalTranscriber,
    _segment_embeds,
    accept_draft,
    cache_capacity_for,
)

log = logging.getLogger(__name__)

degrade_count = 0
last_degrade_error: Optional[str] = None


class _TickPlan:
    """One stream's tick parameters (host side)."""

    __slots__ = ("transcriber", "window", "window_start", "n_audio", "stable", "true_len", "draft", "bucket",
                 "seg_bucket", "capacity")

    def __init__(self, transcriber: IncrementalTranscriber, window, window_start: int):
        model = transcriber.model
        self.transcriber = transcriber
        self.window = as_device_audio(np.asarray(window).reshape(-1))
        self.window_start = window_start
        self.n_audio = model._audio_tokens_for(len(self.window))
        self.stable = transcriber._stable_tokens
        self.true_len = len(model.prefix_ids) + self.n_audio + len(model.suffix_ids)
        self.draft = transcriber._last_generated[:DRAFT_TOKENS]
        self.bucket = bucket_audio_samples(len(self.window))
        seg_true = (self.n_audio - self.stable) + len(model.suffix_ids) + DRAFT_TOKENS
        self.seg_bucket = _round_up(max(1, seg_true), SEGMENT_BUCKET)
        # the one capacity policy: can_extend compares it with _ensure_cache's
        self.capacity = cache_capacity_for(self.true_len + DRAFT_TOKENS + transcriber.max_new_tokens)

    def can_extend(self) -> bool:
        t = self.transcriber
        return (t._cache is not None and t._cache_capacity == self.capacity
                and t._window_start == self.window_start and 0 <= self.stable <= self.n_audio)

    def group_key(self):
        # seg_bucket is not in the key: a group pads every segment to its
        # longest (the padded rows are inert, as in the per-stream segment)
        t = self.transcriber
        return (id(t.model), self.bucket, self.capacity, t.max_new_tokens, self.window.dtype.str)

    fresh_key = group_key


def tick_batch(transcribers: Sequence[IncrementalTranscriber], windows: Sequence[np.ndarray],
               window_starts: Optional[Sequence[int]] = None):
    """One interim tick for each (transcriber, window) pair; results in input
    order, a stream's exception in its place."""
    if window_starts is None:
        window_starts = [0] * len(transcribers)
    results: List = [None] * len(transcribers)
    plans = [_TickPlan(t, w, ws) for t, w, ws in zip(transcribers, windows, window_starts)]
    groups: dict = {}
    fresh_groups: dict = {}
    for i, plan in enumerate(plans):
        if plan.can_extend():
            groups.setdefault(plan.group_key(), []).append(i)
        else:
            fresh_groups.setdefault(plan.fresh_key(), []).append(i)

    solo: List[int] = []
    max_b = max_decode_batch()  # 1 means: never stack KV caches

    def run_chunks(members: List[int], runner) -> None:
        global degrade_count, last_degrade_error
        for c0 in range(0, len(members), max_b):
            chunk = members[c0 : c0 + max_b]
            if len(chunk) == 1:
                solo.extend(chunk)
                continue
            try:
                with torch.no_grad():
                    batch_results = runner([plans[i] for i in chunk])
            except Exception as exc:
                # sessions are untouched on failure (the runners apply state
                # after all device work): each stream ticks on its own
                degrade_count += 1
                last_degrade_error = repr(exc)
                log.warning("batched tick failed; %d streams tick one by one", len(chunk), exc_info=True)
                solo.extend(chunk)
                continue
            for i, r in zip(chunk, batch_results):
                if r is None:  # clip-guard redo or overflow guard: per stream
                    solo.append(i)
                else:
                    results[i] = r

    for members in groups.values():
        run_chunks(members, _run_group)
    for members in fresh_groups.values():
        run_chunks(members, _run_group_fresh)

    for i in solo:
        p = plans[i]
        # one broken request fails alone; the waiter re-raises its exception
        try:
            results[i] = p.transcriber.transcribe_window(p.window, p.window_start)
        except Exception as exc:
            results[i] = exc
    return results


def _layout(plans: List[_TickPlan]):
    model = plans[0].transcriber.model
    bucket = plans[0].bucket
    mel_frames = wmel.num_mel_frames(bucket)
    chunk = model.config.audio.chunk_frames
    num_chunks = max(1, (mel_frames + chunk - 1) // chunk)
    waveforms = np.zeros((len(plans), bucket), dtype=plans[0].window.dtype)
    for b, p in enumerate(plans):
        waveforms[b, : len(p.window)] = p.window
    return model, waveforms, mel_frames, num_chunks


def _encode_batch(model, waveforms: np.ndarray, n_audio: List[int], mel_frames: int, num_chunks: int):
    """Batched mel and encoder: ``(audio embeds [B, A, D], clip max [B])``,
    each stream masked by its own audio-token count."""
    cfg = model.config
    mel, clip_max = wmel.log_mel_with_max(torch.from_numpy(waveforms).to(model.device), mel_frames)
    mel = torch.nn.functional.pad(mel, (0, 0, 0, num_chunks * cfg.audio.chunk_frames - mel.shape[1]))
    return (encode_chunks_batch(model.rank_config.audio, model.encoder_params, mel, n_audio, num_chunks,
                                model.encoder_tp), clip_max)


def _run_group_fresh(plans: List[_TickPlan]):
    """One batched full prefill and decode for two or more fresh sessions;
    the same state handoff as the per-stream full tick."""
    model, waveforms, mel_frames, num_chunks = _layout(plans)
    cfg = model.config
    prefix_len = len(model.prefix_ids)
    capacity = plans[0].capacity
    max_new = plans[0].transcriber.max_new_tokens
    with tracing.span("model.encode"):
        audio_embeds, clip_dev = _encode_batch(model, waveforms, [p.n_audio for p in plans], mel_frames,
                                               num_chunks)

    with tracing.span("model.prefill"):
        bucket_len = _round_up(max(p.true_len for p in plans), SEGMENT_BUCKET)
        ids = np.full((len(plans), bucket_len), cfg.pad_token_id, dtype=np.int64)
        for b, p in enumerate(plans):
            ids[b, : p.true_len] = model._prompt_ids(p.n_audio)
        dtype = dec.torch_dtype(cfg.decoder.compute_dtype)
        embeds = dec.embed_tokens(model.decoder_params, torch.from_numpy(ids).to(model.device)).to(dtype)
        for b, p in enumerate(plans):
            embeds[b, prefix_len : prefix_len + p.n_audio] = audio_embeds[b, : p.n_audio].to(dtype)

        caches = model.place_cache(dec.init_cache_batch(cfg.decoder, len(plans), capacity, model.cache_dtype,
                                                        model.device))
        hidden = dec.forward_prefill_batch(model.rank_config.decoder, model.decoder_params, embeds, caches,
                                           model.tp)
        last = hidden[torch.arange(len(plans), device=hidden.device),
                      torch.tensor([p.true_len - 1 for p in plans], device=hidden.device)]
        first = torch.argmax(dec.logits_for(cfg.decoder, model.decoder_params, last), dim=-1)
        caches.set_positions([p.true_len for p in plans])
    step_times: List[float] = []
    tokens = _decode_greedy_batch(model.rank_config.decoder, model.decoder_params, first, caches, cfg.eos_token_id,
                                  max_new, step_times=step_times, tp=model.tp)
    clip_np = clip_dev.cpu().numpy()

    # parse first (fallible), then apply session state (assignments only)
    staged = []
    for b in range(len(plans)):
        generated = [int(tok) for tok in tokens[b] if tok >= 0]
        staged.append((generated, model._parse_output(generated)))
    results = []
    for b, (p, (generated, parsed)) in enumerate(zip(plans, staged)):
        t = p.transcriber
        t._cache = dec.KVCache(k=caches.k[b], v=caches.v[b], pos=caches.pos_host[b])
        t._cache_capacity = capacity
        t.full_prefills += 1
        t._window_start = p.window_start
        t._clip_max = float(clip_np[b])  # anchored at full prefills
        t._stable_tokens = t._stable_boundary(len(p.window), p.n_audio)
        t._last_generated = generated
        t.last_decode_step_s = step_times
        results.append(parsed)
    return results


def _run_group(plans: List[_TickPlan]):
    """One batched segment tick for two or more compatible extending sessions.
    A stream whose cache the group's segment length would overflow, or whose
    clip guard fires, gets ``None`` (a per-stream tick)."""
    model = plans[0].transcriber.model
    prefix_len = len(model.prefix_ids)
    seg_bucket = max(p.seg_bucket for p in plans)
    ok = [p for p in plans if prefix_len + p.stable + seg_bucket <= p.capacity]
    if len(ok) < 2:
        return [None] * len(plans)
    if len(ok) < len(plans):
        by_id = {id(p): r for p, r in zip(ok, _run_group(ok))}
        return [by_id.get(id(p)) for p in plans]

    model, waveforms, mel_frames, num_chunks = _layout(plans)
    cfg = model.config
    max_new = plans[0].transcriber.max_new_tokens
    with tracing.span("model.encode"):
        audio_embeds, clip_dev = _encode_batch(model, waveforms, [p.n_audio for p in plans], mel_frames,
                                               num_chunks)
    with tracing.span("model.prefill"):
        embeds = torch.stack([_segment_embeds(model, audio_embeds[b], p.n_audio, p.stable, p.draft, seg_bucket)
                              for b, p in enumerate(plans)])

        # a batch copy of the streams' caches: the sessions keep theirs until
        # every stream's results are in
        caches = dec.BatchKVCache(k=torch.stack([p.transcriber._cache.k for p in plans]),
                                  v=torch.stack([p.transcriber._cache.v for p in plans]),
                                  pos=torch.zeros(0), pos_host=[])
        caches.set_positions([prefix_len + p.stable for p in plans])
        hidden = dec.forward_prefill_batch(model.rank_config.decoder, model.decoder_params, embeds, caches,
                                           model.tp)
        # verify each stream's draft on the DRAFT_TOKENS + 1 rows from the one
        # that predicts its first token: the logits head sees only those rows
        first_index = torch.tensor([(p.n_audio - p.stable) + len(model.suffix_ids) - 1 for p in plans],
                                   device=hidden.device)
        rows = torch.clamp(first_index[:, None] + torch.arange(DRAFT_TOKENS + 1, device=hidden.device),
                           max=seg_bucket - 1)
        window_hidden = torch.gather(hidden, 1, rows[..., None].expand(-1, -1, hidden.shape[-1]))
        preds = torch.argmax(dec.logits_for(cfg.decoder, model.decoder_params, window_hidden), dim=-1)
        preds_np, clip_np = preds.cpu().numpy(), clip_dev.cpu().numpy()  # the one sync before decode
    accepted = [accept_draft(preds_np[b].tolist(), p.draft) for b, p in enumerate(plans)]
    first = torch.as_tensor(preds_np[np.arange(len(plans)), accepted], device=model.device)
    caches.set_positions([p.true_len + a for p, a in zip(plans, accepted)])
    step_times: List[float] = []
    tokens = _decode_greedy_batch(model.rank_config.decoder, model.decoder_params, first, caches, cfg.eos_token_id,
                                  max_new, budgets=[max_new - a for a in accepted], step_times=step_times,
                                  tp=model.tp)

    # parse every stream's outcome without touching session state (a raise
    # here leaves all sessions intact), then apply the state
    staged = []
    for b, p in enumerate(plans):
        t = p.transcriber
        if t._clip_max is not None and float(clip_np[b]) > t._clip_max + CLIP_MAX_EPS:
            staged.append(None)
            continue
        generated = list(p.draft[: accepted[b]]) + [int(tok) for tok in tokens[b] if tok >= 0]
        staged.append((generated, model._parse_output(generated)))
    results = []
    for b, (p, s) in enumerate(zip(plans, staged)):
        t = p.transcriber
        if s is None:
            # the per-stream clip guard: the mel clamp floor moved, redo solo
            t.clip_guard_prefills += 1
            t.reset()
            results.append(None)
            continue
        generated, parsed = s
        t._cache = dec.KVCache(k=caches.k[b], v=caches.v[b], pos=caches.pos_host[b])
        t.incremental_prefills += 1
        t.draft_tokens_offered += len(p.draft)
        t.draft_tokens_accepted += accepted[b]
        t._window_start = p.window_start
        t._stable_tokens = t._stable_boundary(len(p.window), p.n_audio)
        t._last_generated = generated
        t.last_decode_step_s = step_times
        results.append(parsed)
    return results

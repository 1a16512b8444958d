"""End-to-end Qwen3-ASR transcriber (counterpart of ``models/qwen3_asr/model.py``).

audio → log-mel → AuT encoder → prompt splice → decoder prefill → greedy
decode → text. Three shape rules of the reference are kept because they are
semantics, not compiler needs:

- audio is bucketed in 0.5 s steps (then powers of two): the reflect pad at
  the true end and the mel frame count depend on the bucket;
- the prompt is end-padded to a 64-token bucket (causality keeps the padding
  inert; the first token comes from the true last row);
- the KV cache capacity is a power of two from 1024.

:meth:`Qwen3ASRModel.transcribe_batch` steps several clips together: one
batched prefill (``forward_prefill_batch``, one weight read per layer for the
batch, where the reference runs ``vmap(forward)``; both compute the same
function) and one batched greedy decode, in chunks of ``max_decode_batch()``
streams (a KV-memory bound). The reference's batch-size buckets and row-0
padding exist only to bound XLA compiles and are not ported.

``Qwen3ASRModel(mesh=)`` serves on a (dp, tp) ``DeviceMesh``, one process a
rank (``parallel.mesh``): each rank loads the artifact, keeps its Megatron
shard of the decoder (and of the encoder where ``tp`` divides its heads) and
its block of the KV heads (:meth:`Qwen3ASRModel.place_cache`), and the
forwards sum the row-parallel outputs over ``tp`` (``decoder``'s module
docstring). The logits head and the embedding stay whole on every rank, so
every rank takes the same argmax and the greedy loops end together.

Every path times its work in three host spans (``runtime/tracing.py``):
``model.encode`` (the host's dispatch of log-mel and encoder),
``model.prefill`` (the host's dispatch of prompt embeds, decoder prefill and
first logits; neither adds a sync, so the device's encode and prefill time
is waited for at the first token's read, before the first step) and
``model.decode.step`` (one decode step, closed by its one sync,
``model.decode.sync``, the host waiting for the device). A step's wall is
also its entry in ``last_decode_step_s``.

The reference's load-overlapped shadow warmup works around XLA compile walls
and the TPU relay; it is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from light_whisper_tpu_torch.models.qwen3_asr.config import Qwen3ASRConfig, conv_output_length
from light_whisper_tpu_torch.models.qwen3_asr.prompt import resolve_prompt_ids
from light_whisper_tpu_torch.audio import mel as wmel
from light_whisper_tpu_torch.audio.mel import SAMPLE_RATE
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr import step_graph
from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode, encode_chunks
from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights, _to_device
from light_whisper_tpu_torch.runtime import tracing

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


def max_decode_batch() -> int:
    """Operator bound on the decode batch (``LWT_MAX_DECODE_BATCH``, default 8).

    KV memory scales with it (B × L × Hkv × C × hd × 2 × k/v: 117 MB a stream
    at 0.6B and C = 1024); malformed values fall back to the default."""
    try:
        return max(1, int(os.environ.get("LWT_MAX_DECODE_BATCH", "8")))
    except ValueError:
        return 8


@dataclasses.dataclass
class BatchPlan:
    """:meth:`Qwen3ASRModel.batch_plan`'s host layout of a batch."""

    padded: np.ndarray  # [B, audio bucket]
    true_samples: List[int]
    ids: np.ndarray  # [B, prompt bucket] int64, pad-filled
    prompt_lens: List[int]
    capacity: int  # the KV capacity of every stream


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


def _prefill_batch(cfg, params: Dict, embeds: torch.Tensor, cache: dec.BatchKVCache,
                   last_indices: Sequence[int], tp=dec.Replicated) -> torch.Tensor:
    """Prefill ``embeds [B, T, D]`` into ``cache``; returns each stream's
    first greedy token (argmax at its row ``last_indices[b]``), on the device."""
    hidden = dec.forward_prefill_batch(cfg, params, embeds, cache, tp)
    rows = torch.as_tensor(list(last_indices), device=hidden.device)
    last = hidden[torch.arange(hidden.shape[0], device=hidden.device), rows]  # [B, D]
    return torch.argmax(dec.logits_for(cfg, params, last), dim=-1)


def _decode_greedy_batch(
    cfg,
    params: Dict,
    first_tokens: torch.Tensor,  # [B] on the device
    cache: dec.BatchKVCache,
    eos_token_id: int,
    max_new_tokens: int,
    budgets: Optional[Sequence[int]] = None,
    step_times: Optional[List[float]] = None,
    tp=dec.Replicated,
) -> np.ndarray:
    """Batched greedy decode: all streams step together until every one has
    emitted EOS or used its budget; a stream's token is recorded only while it
    is not done. Returns ``[B, max_new_tokens]`` int64 ids, ``-1`` in unused
    slots.

    ``budgets`` caps tokens per stream below ``max_new_tokens``. A step
    (``dec.decode_step``, then the EOS and budget update of ``done``
    against the step count kept on the device) reads and writes only buffers
    made here and the cache, so where ``dec.graphs_engage`` it is captured
    once and replayed (``step_graph``). The one host sync per step is the
    ``done.all()`` check (``model.decode.sync``); it closes the step's span,
    whose wall ``step_times`` collects. The reference's final step, whose
    token is never recorded, is skipped."""
    dev = first_tokens.device
    B = first_tokens.shape[0]
    tokens = torch.full((B, max_new_tokens), -1, dtype=torch.int64, device=dev)
    current = first_tokens.to(torch.int64, copy=True)  # every step writes its argmax here
    done = current == eos_token_id
    most = max_new_tokens - 1  # steps the loop may run: the step after the last budget's token ends it
    if budgets is not None:
        budgets = list(budgets)
        most = min(most, max(budgets, default=0))
        budgets = torch.as_tensor(budgets, dtype=torch.int64, device=dev)
        done |= budgets <= 0
    steps = torch.zeros((), dtype=torch.int64, device=dev)

    def body() -> None:
        dec.decode_step(cfg, params, current, cache, tp)
        steps.add_(1)
        newly_done = current == eos_token_id
        if budgets is not None:
            newly_done |= steps >= budgets
        done.logical_or_(newly_done)

    count = 0
    all_done = bool(done.all())
    with step_graph.StepGraph(body, cache, dec.graphs_engage(cfg, dev, most, tp)) as run:
        while count < max_new_tokens and not all_done:
            tokens[:, count] = torch.where(done, -1, current)
            count += 1
            if count == max_new_tokens:
                break
            with tracing.span("model.decode.step") as step:
                run()
                with tracing.span("model.decode.sync"):
                    all_done = bool(done.all())
            if step_times is not None:
                step_times.append(step.seconds)
    return tokens.cpu().numpy()


class Qwen3ASRModel:
    def __init__(
        self,
        gguf_path: str,
        device="cuda",
        max_new_tokens: int = 448,
        precise: bool = False,
        mesh=None,
    ) -> None:
        """``precise=True``: dense f32 weights, f32 compute and f32 KV cache.

        ``mesh``: a (dp, tp) ``DeviceMesh`` from ``parallel.mesh.make_mesh``;
        this process is one rank of it and computes on its device (``device``
        is then not read). ``tp`` must divide the KV heads, as in the
        reference. Each rank loads the artifact on the host and uploads its
        shards only."""
        self.mesh = mesh
        # the widths this rank computes, and the seams of its forwards (the
        # encoder's too, or Replicated where every rank keeps it whole)
        self.tp = self.encoder_tp = dec.Replicated
        if mesh is None:
            self.device = resolve_device(device)
            weights = Qwen3ASRWeights(gguf_path, device=self.device, precise=precise)
            self.rank_config = weights.config
            self.decoder_params, self.encoder_params = weights.decoder_params, weights.encoder_params
        else:
            from light_whisper_tpu_torch.parallel import mesh as pmesh
            from light_whisper_tpu_torch.parallel import sharding

            self.device = pmesh.mesh_device(mesh)
            self._tp_rank = mesh.get_local_rank(pmesh.MODEL_AXIS)
            self._tp_size = mesh[pmesh.MODEL_AXIS].size()
            weights = Qwen3ASRWeights(gguf_path, device="cpu", precise=precise)  # host trees
            self.rank_config, encoder_sharded = sharding.serving_config(weights.config, self._tp_size)
            self.tp = sharding.TensorParallel(mesh)
            decoder = sharding.shard_tree(weights.decoder_params, self._tp_rank, self._tp_size, weights.config.decoder)
            encoder = weights.encoder_params
            if encoder_sharded:
                self.encoder_tp = self.tp
                encoder = sharding.shard_tree(encoder, self._tp_rank, self._tp_size)
            # only this rank's shards cross to the device
            t0 = time.perf_counter()
            self.decoder_params = _to_device(decoder, self.device)
            self.encoder_params = _to_device(encoder, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            weights.load_timings["device_upload_s"] = round(time.perf_counter() - t0, 3)
        self.load_timings = dict(weights.load_timings)
        self.config: Qwen3ASRConfig = weights.config
        self.tokenizer = weights.tokenizer
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

    def _capacity_for(self, needed: int) -> int:
        capacity = 1024
        while capacity < needed:
            capacity *= 2
        capacity = min(capacity, self.config.decoder.context_length)
        if needed > capacity:
            raise ValueError(
                f"prompt+decode budget {needed} exceeds context {self.config.decoder.context_length}"
            )
        return capacity

    def _cache_for(self, needed: int) -> dec.KVCache:
        return self.place_cache(dec.init_cache(self.config.decoder, self._capacity_for(needed), self.cache_dtype,
                                               self.device))

    def place_cache(self, cache):
        """A fresh cache (``KVCache`` or ``BatchKVCache`` of every KV head) as
        this rank keeps it: its block of the KV heads under a mesh (the
        reference's ``P(None, "tp", None, None)``), the cache itself without.
        The one placing site of every cache owner, the sessions' included."""
        if self.mesh is None:
            return cache
        from light_whisper_tpu_torch.parallel.sharding import shard_cache

        return shard_cache(cache, self._tp_rank, self._tp_size)

    def _prepare(self, audio: np.ndarray):
        """Host-side request layout: ``(padded audio, n_audio, padded prompt ids,
        true prompt length, mel frames, encoder chunks)``."""
        audio = as_device_audio(np.asarray(audio).reshape(-1))
        bucket = bucket_audio_samples(len(audio))
        padded = np.zeros(bucket, dtype=audio.dtype)
        padded[: len(audio)] = audio
        n_audio = self._audio_tokens_for(len(audio))
        ids = self._prompt_ids(n_audio)
        true_len = len(ids)
        ids_padded = np.full(_round_up(true_len, PROMPT_BUCKET), self.config.pad_token_id, dtype=np.int64)
        ids_padded[:true_len] = ids
        mel_frames = wmel.num_mel_frames(bucket)
        chunk = self.config.audio.chunk_frames
        num_chunks = max(1, (mel_frames + chunk - 1) // chunk)
        return padded, n_audio, ids_padded, true_len, mel_frames, num_chunks

    def _encode_and_prefill(self, padded, n_audio, ids_padded, true_len, mel_frames, num_chunks, cache):
        """log-mel → encoder → prompt splice → prefill; returns the logits of
        the true last prompt row and the clip's mel max (a device scalar: the
        streaming session's clip guard reads it), and leaves ``cache.pos`` at
        ``true_len``."""
        with tracing.span("model.encode"):
            waveform = torch.from_numpy(padded).to(self.device)
            mel, clip_max = wmel.log_mel_with_max(waveform, mel_frames)
            chunk = self.config.audio.chunk_frames
            mel = torch.nn.functional.pad(mel, (0, 0, 0, num_chunks * chunk - mel.shape[0]))
            audio_embeds = encode_chunks(self.rank_config.audio, self.encoder_params, mel, n_audio, num_chunks,
                                         self.encoder_tp)
        with tracing.span("model.prefill"):
            dtype = dec.torch_dtype(self.config.decoder.compute_dtype)
            ids = torch.from_numpy(ids_padded).to(self.device)
            embeds = _build_prompt_embeds(self.decoder_params, ids, audio_embeds, n_audio,
                                          len(self.prefix_ids), dtype)
            hidden = dec.forward(self.rank_config.decoder, self.decoder_params, embeds, cache, self.tp)
            # the padded tail wrote K/V at positions >= true_len; decode overwrites
            # them before reading (causal masking keeps positions < true_len exact)
            cache.pos = true_len
            logits = dec.logits_for(self.config.decoder, self.decoder_params, hidden[true_len - 1][None])[0]
        return logits, clip_max

    @torch.no_grad()
    def transcribe(self, audio: np.ndarray) -> TranscriptionResult:
        """Greedy transcription of mono 16 kHz audio (float32 or int16)."""
        request = self._prepare(audio)
        cache = self._cache_for(len(request[2]) + self.max_new_tokens)
        logits, _clip_max = self._encode_and_prefill(*request, cache)
        self.last_decode_step_s = []
        generated = dec.decode_greedy(
            self.rank_config.decoder,
            self.decoder_params,
            torch.argmax(logits),
            cache,
            self.config.eos_token_id,
            self.max_new_tokens,
            step_times=self.last_decode_step_s,
            tp=self.tp,
        )
        return self._parse_output(generated)

    @torch.no_grad()
    def transcribe_batch(self, audios: Sequence[np.ndarray]) -> List[TranscriptionResult]:
        """Batched greedy transcription of several clips.

        Every clip is padded to the longest one's audio bucket and encoded with
        that bucket's valid-token count (the reference's ``_encode_padded``),
        every prompt to one 64-token bucket; the streams then prefill and
        decode together, ``max_decode_batch()`` at a time. One clip takes
        :meth:`transcribe`."""
        if not audios:
            return []
        if len(audios) == 1:
            return [self.transcribe(audios[0])]
        plan = self.batch_plan(audios)
        self.last_decode_step_s = []
        tokens = self.decode_rows(plan, 0, len(audios))
        return [self._parse_output([int(t) for t in row if t >= 0]) for row in tokens]

    def batch_plan(self, audios: Sequence[np.ndarray]) -> BatchPlan:
        """The host layout of a batch: every clip padded to the longest one's
        audio bucket, every prompt to one 64-token bucket, one KV capacity."""
        audios = [as_device_audio(np.asarray(a).reshape(-1)) for a in audios]
        if any(a.dtype != np.int16 for a in audios):
            # one array for all clips: int16 ones scale as the mel front end would (exact)
            audios = [a.astype(np.float32) / np.float32(32768.0) if a.dtype == np.int16 else a for a in audios]
        bucket = max(bucket_audio_samples(len(a)) for a in audios)
        padded = np.zeros((len(audios), bucket), dtype=audios[0].dtype)
        for row, audio in enumerate(audios):
            padded[row, : len(audio)] = audio
        true_samples = [len(a) for a in audios]
        prompts = [self._prompt_ids(self._audio_tokens_for(n)) for n in true_samples]
        prompt_lens = [len(p) for p in prompts]
        bucket_len = _round_up(max(prompt_lens), PROMPT_BUCKET)
        ids = np.full((len(audios), bucket_len), self.config.pad_token_id, dtype=np.int64)
        for row, prompt in enumerate(prompts):
            ids[row, : len(prompt)] = prompt
        return BatchPlan(padded, true_samples, ids, prompt_lens, self._capacity_for(bucket_len + self.max_new_tokens))

    def decode_rows(self, plan: BatchPlan, lo: int, hi: int) -> np.ndarray:
        """Greedy tokens of the plan's streams ``lo..hi`` (``[hi - lo,
        max_new_tokens]``, ``-1`` past each stream's end): encoded in one pass,
        then prefilled and decoded together, ``max_decode_batch()`` at a time.
        A stream's row does not depend on which others share its call."""
        with tracing.span("model.encode"):
            audio_embeds, n_audio = self._encode_padded(plan.padded[lo:hi], plan.true_samples[lo:hi])
        ids = torch.from_numpy(plan.ids[lo:hi]).to(self.device)
        compute = dec.torch_dtype(self.config.decoder.compute_dtype)
        prompt_lens = plan.prompt_lens[lo:hi]
        out = []
        max_b = max_decode_batch()
        for c0 in range(0, hi - lo, max_b):
            rows = range(c0, min(c0 + max_b, hi - lo))
            lens = prompt_lens[c0 : rows.stop]
            with tracing.span("model.prefill"):
                embeds = torch.stack([
                    _build_prompt_embeds(self.decoder_params, ids[row], audio_embeds[row], n_audio[row],
                                         len(self.prefix_ids), compute)
                    for row in rows
                ])
                cache = self.place_cache(dec.init_cache_batch(self.config.decoder, len(lens), plan.capacity,
                                                              self.cache_dtype, self.device))
                firsts = _prefill_batch(self.rank_config.decoder, self.decoder_params, embeds, cache,
                                        [n - 1 for n in lens], self.tp)
                # the padded tails wrote K/V past each stream's prompt; decode
                # overwrites them one position at a time before any read
                cache.set_positions(lens)
            out.append(_decode_greedy_batch(self.rank_config.decoder, self.decoder_params, firsts, cache,
                                            self.config.eos_token_id, self.max_new_tokens,
                                            step_times=self.last_decode_step_s, tp=self.tp))
        return np.concatenate(out) if out else np.full((0, self.max_new_tokens), -1, np.int64)

    def _encode_padded(self, padded: np.ndarray, true_samples: Sequence[int]):
        """Encode clips already padded to one bucket (``[B, bucket]``) in one
        pass. As in the reference, the encoder masks by the padded bucket's
        valid-token count, not the clip's own (``transcribe`` uses the clip's);
        returns ``(embeds [B, tokens, D], each clip's own audio-token count)``."""
        mel = wmel.log_mel(torch.from_numpy(padded).to(self.device))
        embeds, _valid = encode(self.rank_config.audio, self.encoder_params, mel, self.encoder_tp)
        return embeds, [self._audio_tokens_for(n) for n in true_samples]

    @torch.no_grad()
    def teacher_forced_logits(self, audio: np.ndarray, tokens: List[int]) -> List[torch.Tensor]:
        """Logits after the prompt and after each of ``tokens`` fed in turn
        (``len(tokens) + 1`` rows of the padded vocab, f32 on the host). Used to
        read the top-2 gap where two implementations' greedy paths part."""
        request = self._prepare(audio)
        cache = self._cache_for(len(request[2]) + len(tokens) + 1)
        rows = [self._encode_and_prefill(*request, cache)[0]]
        for tok in tokens:
            ids = torch.tensor([tok], device=self.device)
            hidden = dec.forward(self.rank_config.decoder, self.decoder_params,
                                 dec.embed_tokens(self.decoder_params, ids), cache, self.tp)
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

    def _prompt_ids(self, n_audio: int) -> List[int]:
        return self.prefix_ids + [self.config.audio_token_id] * n_audio + self.suffix_ids

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

"""The port's multi-device dry run (counterpart of
``__graft_entry__.dryrun_multichip`` and its serving legs).

    python -m light_whisper_tpu_torch.parallel.dryrun --devices N [--device cpu]

spawns N ranks, one process each, joined over a ``FileStore`` in a temporary
directory (NCCL on ``cuda``, which needs N cards; gloo on ``cpu``), and runs
the reference's legs in its order, each rank holding its result against one
device and every rank's greedy tokens against each other's:

1. one dp × tp fine-tuning step (``parallel.train``);
2. a tp-sharded greedy decode against the same decode on one device;
3. the GPipe pipeline (``parallel.pipeline``): forward against
   ``forward_train``, and one train step;
4. the tp-sharded incremental tick (fresh, then extending) against one
   device, on a dense tiny model;
5. the Q8 tp tick, a smoke: its tokens and where they part from one device
   are printed, not held (a row-parallel sum in another order may flip a
   greedy near-tie on quantised noise, the reference's doctrine);
6. the dp-split batched decode (:func:`transcribe_batch_dp`) against the
   unsplit ``transcribe_batch``.

Rank 0 prints one line a leg, worded as the reference's. A rank that fails,
or does not finish within the timeout, fails the run. The models are random,
written from seeds by ``models/qwen3_asr/synthetic.py``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr import synthetic
from light_whisper_tpu_torch.models.qwen3_asr.config import AudioEncoderConfig, DecoderConfig, Qwen3ASRConfig
from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel, TranscriptionResult
from light_whisper_tpu_torch.parallel import mesh as pmesh
from light_whisper_tpu_torch.parallel import pipeline, sharding, train

SAMPLE_RATE = 16_000
RANK_TIMEOUT_S = 600.0


def transcribe_batch_dp(model: Qwen3ASRModel, audios: Sequence[np.ndarray], mesh) -> List[TranscriptionResult]:
    """``model.transcribe_batch`` with the streams split over the mesh's
    ``dp`` ranks (the reference's ``_BatchShardedModel``): dp rank ``r`` takes
    a contiguous block of the streams and decodes it; the blocks' tokens come
    back by an all-gather over ``dp``, so every rank returns every stream.

    Every block keeps the whole batch's audio bucket, prompt bucket and KV
    capacity (``model.batch_plan``): a block sized on its own would change the
    decode attention's split count and the encoder's bucket-wide mask, and its
    rows would not be the whole batch's rows."""
    if not audios:
        return []
    dp, index = mesh[pmesh.DATA_AXIS].size(), mesh.get_local_rank(pmesh.DATA_AXIS)
    plan = model.batch_plan(audios)
    per = -(-len(audios) // dp)
    lo, hi = min(index * per, len(audios)), min((index + 1) * per, len(audios))
    block = np.full((per, model.max_new_tokens), -1, np.int64)
    model.last_decode_step_s = []
    if hi > lo:
        block[: hi - lo] = model.decode_rows(plan, lo, hi)
    local = torch.from_numpy(block).to(model.device)
    parts = [torch.empty_like(local) for _ in range(dp)]
    dist.all_gather(parts, local, group=mesh.get_group(pmesh.DATA_AXIS))
    tokens = torch.cat(parts)[: len(audios)].cpu().numpy()
    return [model._parse_output([int(t) for t in row if t >= 0]) for row in tokens]


def same_on_every_rank(value, what: str):
    """``value`` after checking that every rank of the default group holds
    the same (a rank that parted would leave a greedy loop while another
    waits in its all-reduce)."""
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, value)
    if any(v != everyone[0] for v in everyone):
        raise AssertionError(f"{what} differs between the ranks: {everyone}")
    return value


def first_parting(a: Sequence[int], b: Sequence[int]) -> str:
    """Where two token lists part, for a printed smoke result."""
    if list(a) == list(b):
        return "identical"
    step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return f"parts at step {step}"


# -- the dry run's models ------------------------------------------------------


def train_config() -> Qwen3ASRConfig:
    """The reference's dry-run training widths (``__graft_entry__``), with
    heads of 64 (the reference's are 16): the tp decode leg's attention is
    the decode-attention kernel on a card, which takes heads of 64, 128 or
    256."""
    return Qwen3ASRConfig(
        audio=AudioEncoderConfig(num_mel_bins=128, d_model=128, block_count=2, head_count=8, feed_forward_length=256,
                                 downsample_hidden_size=32, output_dim=128, n_window=50, n_window_infer=400,
                                 max_source_positions=64),
        decoder=DecoderConfig(vocab_size=512, embedding_length=128, block_count=2, feed_forward_length=256,
                              head_count=8, head_count_kv=4, key_length=64, context_length=512),
        audio_token_id=500, bos_token_id=501, eos_token_id=502, pad_token_id=503)


def tiny_config() -> Qwen3ASRConfig:
    """The serving legs' model: 4 query heads over 2 KV heads of 128 (the
    tests' tiny fixture's head counts, at the kernels' head dim), decoder and
    encoder 256 wide, so that a tp=2 rank's Q8 products contract at least
    128 in-features on a card."""
    return Qwen3ASRConfig(
        audio=AudioEncoderConfig(num_mel_bins=128, d_model=256, block_count=2, head_count=4, feed_forward_length=512,
                                 downsample_hidden_size=32, output_dim=256, n_window=50, n_window_infer=400,
                                 max_source_positions=200),
        decoder=DecoderConfig(vocab_size=512, embedding_length=256, block_count=2, feed_forward_length=512,
                              head_count=4, head_count_kv=2, key_length=128, context_length=2048),
        audio_token_id=500, bos_token_id=501, eos_token_id=502, pad_token_id=503)


def write_models(directory: str) -> None:
    """The GGUFs every rank loads: the training widths (dense), the tiny
    serving model dense and in Q8_0."""
    synthetic.write_model(os.path.join(directory, "train.gguf"), train_config(), seed=1, quantize=False)
    synthetic.write_model(os.path.join(directory, "tiny.gguf"), tiny_config(), seed=0, quantize=False)
    synthetic.write_model(os.path.join(directory, "tiny-q8.gguf"), tiny_config(), seed=0, quantize=True)


# -- the legs ------------------------------------------------------------------------


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def _tp_of(n: int) -> int:
    return 2 if n % 2 == 0 else 1


def leg_train(directory: str, n: int, device: str) -> None:
    from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights

    cfg = train_config()
    tp = _tp_of(n)
    dp = n // tp
    mesh = pmesh.make_mesh(dp=dp, tp=tp, device_type=device)
    weights = Qwen3ASRWeights(os.path.join(directory, "train.gguf"))
    prefix = 4
    state = train.init_state(mesh, weights.encoder_params, weights.decoder_params, train.adamw(1e-4), cfg, device)
    step, place = train.make_train_step(cfg, mesh, prefix, device)
    num_chunks = 1
    n_audio = num_chunks * cfg.audio.tokens_per_chunk
    T = prefix + n_audio + 8
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((dp, num_chunks * cfg.audio.chunk_frames, cfg.audio.num_mel_bins)).astype(np.float32)
    ids = rng.integers(0, 256, size=(dp, T)).astype(np.int32)
    labels = np.full((dp, T), train.IGNORE_LABEL, dtype=np.int32)
    labels[:, prefix + n_audio:] = rng.integers(0, 256, size=(dp, T - prefix - n_audio))
    state, loss = step(state, *place(mel, ids, labels))
    loss_value = same_on_every_rank(float(loss), "the train loss")
    assert state.step == 1 and np.isfinite(loss_value), (state.step, loss_value)
    _say(f"dryrun_multichip OK: mesh=dp{dp}xtp{tp} loss={loss_value:.4f}")


def leg_decode(directory: str, n: int, device: str) -> None:
    from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights

    cfg = train_config()
    tp = _tp_of(n)
    mesh = pmesh.make_mesh(dp=n // tp, tp=tp, device_type=device)
    where = pmesh.mesh_device(mesh)
    params = Qwen3ASRWeights(os.path.join(directory, "train.gguf"), device=where).decoder_params
    embeds = torch.from_numpy(np.random.default_rng(2).standard_normal((8, cfg.decoder.embedding_length))
                              .astype(np.float32)).to(where, torch.bfloat16)

    def run(dcfg, p, cache, tp_seams):
        dec.forward(dcfg, p, embeds, cache, tp_seams)
        cache.pos = 8
        return dec.decode_greedy(dcfg, p, torch.tensor(7, device=where), cache, -2, 16, tp=tp_seams)

    with torch.no_grad():
        plain = run(cfg.decoder, params, dec.init_cache(cfg.decoder, 128, device=where), dec.Replicated)
        rank_cfg, _ = sharding.serving_config(cfg, tp)
        index = mesh.get_local_rank(pmesh.MODEL_AXIS)
        shard = sharding.shard_tree(params, index, tp, cfg.decoder)
        cache = sharding.shard_cache(dec.init_cache(cfg.decoder, 128, device=where), index, tp)
        sharded = run(rank_cfg.decoder, shard, cache, sharding.TensorParallel(mesh))
    same_on_every_rank(sharded, "the tp decode's tokens")
    assert sharded == plain, (plain, sharded)
    _say(f"dryrun_multichip decode OK: tp{tp}-sharded greedy decode matches single-device ({len(plain)} tokens)")


def leg_pipeline(directory: str, n: int, device: str) -> None:
    from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights

    cfg = train_config().decoder
    pp = 2 if cfg.block_count % 2 == 0 and n % 2 == 0 else 1
    mesh = pipeline.make_pp_mesh(pp, dp=n // pp, device_type=device)
    where = pmesh.mesh_device(mesh)
    params = Qwen3ASRWeights(os.path.join(directory, "train.gguf")).decoder_params
    M, T = 3, 10
    rng = np.random.default_rng(4)
    embeds_mb = torch.from_numpy(rng.standard_normal((M, T, cfg.embedding_length)).astype(np.float32)).to(where)
    with torch.no_grad(), train.f32_matmuls():
        hidden = pipeline.forward_train_pp(cfg, pipeline.place_decoder_params_pp(params, mesh), embeds_mb, mesh)
        want0 = dec.forward_train(cfg, train.tree_map(params, lambda t: t.to(where)), embeds_mb[0])
    err = float((hidden[0] - want0).abs().max())
    assert err <= 2e-3 + 2e-3 * float(want0.abs().max()), err
    labels = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, size=(M, T)))
    state = pipeline.init_state_pp(mesh, params, train.adam(1e-3), cfg)
    state, loss = pipeline.make_train_step_pp(cfg, mesh)(state, embeds_mb, labels)
    loss_value = same_on_every_rank(float(loss), "the pipeline loss")
    assert np.isfinite(loss_value), loss_value
    _say(f"dryrun_multichip pipeline OK: pp{pp} staged forward matches single-device; "
         f"train-step loss={loss_value:.4f}")


def _ticks(model: Qwen3ASRModel, audio: np.ndarray):
    from light_whisper_tpu_torch.serving.incremental import IncrementalTranscriber

    inc = IncrementalTranscriber(model, max_new_tokens=6)
    fresh = inc.transcribe_window(audio[: SAMPLE_RATE + 8000], 0)
    extended = inc.transcribe_window(audio[: SAMPLE_RATE + 16000], 0)
    assert inc.incremental_prefills >= 1, "the extending tick did not extend"
    return fresh.tokens, extended.tokens


def legs_serving(directory: str, n: int, device: str) -> None:
    tp = _tp_of(n)
    dense, q8 = os.path.join(directory, "tiny.gguf"), os.path.join(directory, "tiny-q8.gguf")
    audio = (np.random.default_rng(7).standard_normal(2 * SAMPLE_RATE) * 0.1).astype(np.float32)

    # (a) the incremental tick, fresh then extending, tp vs one device
    tp_mesh = pmesh.make_mesh(dp=n // tp, tp=tp, device_type=device)
    plain = _ticks(Qwen3ASRModel(dense, device=device, max_new_tokens=6), audio)
    sharded = same_on_every_rank(_ticks(Qwen3ASRModel(dense, max_new_tokens=6, mesh=tp_mesh), audio),
                                 "the tp tick's tokens")
    assert sharded == plain, (plain, sharded)
    _say(f"dryrun_multichip serving OK: tp{tp}-sharded incremental tick (KV rollback + tail prefill + draft "
         f"verify) matches single-device ({len(plain[1])} tokens)")

    # (a') the Q8 tick over the same mesh: a smoke, printed
    q8_plain = _ticks(Qwen3ASRModel(q8, device=device, max_new_tokens=6), audio)
    q8_tp = same_on_every_rank(_ticks(Qwen3ASRModel(q8, max_new_tokens=6, mesh=tp_mesh), audio),
                               "the Q8 tp tick's tokens")
    _say(f"dryrun_multichip serving OK: tp{tp}-sharded Q8 incremental tick compiled and executed "
         f"({len(q8_tp[1])} tokens: {q8_tp[1]}; against one device: {first_parting(q8_plain[1], q8_tp[1])})")

    # (b) the dp-split batched decode against the unsplit batch
    dp = next(d for d in (4, 3, 2, 1) if n % d == 0)
    dp_mesh = pmesh.make_mesh(dp=dp, tp=n // dp, device_type=device)
    rng = np.random.default_rng(1)
    streams = [(rng.standard_normal(8000 + 2000 * i) * 0.3).astype(np.float32) for i in range(dp)]
    model = Qwen3ASRModel(dense, max_new_tokens=6, mesh=dp_mesh)
    whole = [r.tokens for r in model.transcribe_batch(streams)]
    split = same_on_every_rank([r.tokens for r in transcribe_batch_dp(model, streams, dp_mesh)],
                               "the dp batch's tokens")
    assert split == whole, (whole, split)
    _say(f"dryrun_multichip serving OK: dp{dp}-sharded multi-stream batched decode matches single-device "
         f"({dp} streams)")


def rank_main(directory: str, rank: int, n: int, device: str) -> None:
    """One rank of the dry run: join the group, run every leg, leave."""
    if device == "cpu":
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(directory, "store"), n)
    pmesh.init_distributed(device, rank, n, store=store, timeout_s=RANK_TIMEOUT_S / 2)
    try:
        leg_train(directory, n, device)
        leg_decode(directory, n, device)
        leg_pipeline(directory, n, device)
        legs_serving(directory, n, device)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout_s: float = RANK_TIMEOUT_S) -> None:
    """Run the dry run on ``n_devices`` ranks (see the module docstring); rank
    0's lines go to this process's standard output. Raises if a rank fails
    or outlives ``timeout_s``."""
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks on cuda need {n_devices} cards, found {torch.cuda.device_count()}")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="lwt-dryrun-") as directory:
        write_models(directory)
        procs = [subprocess.Popen([sys.executable, "-m", "light_whisper_tpu_torch.parallel.dryrun", "--rank", str(r),
                                   "--devices", str(n_devices), "--device", device, "--dir", directory],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n_devices)]
        logs = [""] * n_devices
        try:
            for r, proc in enumerate(procs):
                logs[r], _ = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"a rank of the dry run did not finish in {timeout_s:.0f} s") from None
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
        print(logs[0], end="", flush=True)
        failed = [r for r, proc in enumerate(procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"dry-run rank {failed[0]} exited {procs[failed[0]].returncode}:\n"
                               f"{logs[failed[0]][-4000:]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, required=True, help="ranks, one process each")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda: NCCL, one card a rank; cpu: gloo")
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dir", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        rank_main(args.dir, args.rank, args.devices, args.device)
        return 0
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

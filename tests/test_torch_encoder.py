"""Port AuT encoder against ``encode_chunks_batch`` of the JAX package.

Both run from the same parameter trees (the reference's, taken to numpy and
through ``params_from_numpy``) on the same numpy-seeded mel. Activations are
bf16, so the bound is max|Δ| <= 2e-2 · max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.tiny_model import write_tiny_model
from light_whisper_tpu.models.qwen3_asr.config import conv_output_length
from light_whisper_tpu.models.qwen3_asr.encoder import encode as ref_encode_mel
from light_whisper_tpu.models.qwen3_asr.encoder import encode_chunks_batch as ref_encode
from light_whisper_tpu.models.qwen3_asr.encoder import sinusoid_positions as ref_positions
from light_whisper_tpu.models.qwen3_asr.loader import Qwen3ASRWeights as RefWeights
from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode, encode_chunks_batch, sinusoid_positions
from light_whisper_tpu_torch.models.qwen3_asr.params import params_from_numpy


@pytest.fixture(scope="module", params=[True, False], ids=["q8_0", "dense"])
def weights(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("enc") / "m.gguf")
    write_tiny_model(path, quantize=request.param, seed=4)
    ref = RefWeights(path)
    enc, _dec = params_from_numpy(jax.tree.map(np.asarray, ref.encoder_params), {}, device="cpu")
    return ref, enc


def test_sinusoid_table_matches():
    np.testing.assert_array_equal(sinusoid_positions(300, 64), ref_positions(300, 64))


@pytest.mark.parametrize("frames_per_stream", [[250], [520, 130]], ids=["one-stream", "two-streams"])
def test_encoder_matches_reference(weights, frames_per_stream):
    ref, enc = weights
    cfg = ref.config.audio
    chunk = cfg.chunk_frames
    num_chunks = max((f + chunk - 1) // chunk for f in frames_per_stream)
    rng = np.random.default_rng(7)
    mel = np.zeros((len(frames_per_stream), num_chunks * chunk, cfg.num_mel_bins), np.float32)
    valid = []
    for b, frames in enumerate(frames_per_stream):
        mel[b, :frames] = rng.standard_normal((frames, cfg.num_mel_bins)) * 0.5
        full, tail = divmod(frames, chunk)
        valid.append(full * cfg.tokens_per_chunk + (conv_output_length(tail) if tail else 0))
    want = np.asarray(
        ref_encode(cfg, ref.encoder_params, jnp.asarray(mel), jnp.asarray(valid, jnp.int32), num_chunks)
        .astype(jnp.float32)
    )
    got = encode_chunks_batch(cfg, enc, torch.from_numpy(mel), valid, num_chunks)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    for b, n in enumerate(valid):  # rows past the valid count are garbage by contract
        ref_rows = want[b, :n]
        err = np.abs(got[b, :n].float().numpy() - ref_rows).max()
        assert err <= 2e-2 * np.abs(ref_rows).max(), (b, err, np.abs(ref_rows).max())


@pytest.mark.parametrize("frames", [250, 300])
def test_encode_pads_to_chunks_and_counts_every_frame(weights, frames):
    """``encode`` (the reference's host wrapper): pad to whole chunks, valid
    count from all of ``frames``; a [B, frames, mels] batch gives each clip
    what it gets alone."""
    ref, enc = weights
    cfg = ref.config.audio
    rng = np.random.default_rng(frames)
    mels = (rng.standard_normal((2, frames, cfg.num_mel_bins)) * 0.5).astype(np.float32)
    got, valid = encode(cfg, enc, torch.from_numpy(mels))
    for b in range(2):
        want, want_valid = ref_encode_mel(cfg, ref.encoder_params, mels[b])
        one, one_valid = encode(cfg, enc, torch.from_numpy(mels[b]))
        assert valid == one_valid == want_valid
        want = np.asarray(want.astype(jnp.float32))[:valid]
        for rows in (got[b, :valid], one[:valid]):
            err = np.abs(rows.float().numpy() - want).max()
            assert err <= 2e-2 * np.abs(want).max(), (b, err)

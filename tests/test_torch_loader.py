"""Port GGUF loader and ``params_from_numpy`` against the reference's
``Qwen3ASRWeights``: identical tree structure and bit-identical leaves for
Q8_0, Q4_0 (int8-expanded), dense, llama-permuted and precise artifacts."""

import dataclasses
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from helpers.tiny_model import tiny_config, tiny_tensors, tiny_vocab
from light_whisper_tpu.formats import gguf
from light_whisper_tpu.models.qwen3_asr import names
from light_whisper_tpu.models.qwen3_asr.export import write_model
from light_whisper_tpu.models.qwen3_asr.loader import Qwen3ASRWeights as RefWeights
from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights, to_bf16
from light_whisper_tpu_torch.models.qwen3_asr.params import params_from_numpy


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _bits(a):
    """Leaf → (dtype name, raw bits) for a bitwise comparison."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return "bfloat16", a.view(torch.int16).numpy()
        return str(a.numpy().dtype), a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.int16)
    return str(a.dtype), a


def _assert_same_trees(ref_tree, port_tree):
    ref = _flatten(ref_tree)
    port = _flatten(port_tree)
    assert sorted(ref) == sorted(port)
    for key in ref:
        rd, rb = _bits(ref[key])
        pd, pb = _bits(port[key])
        assert rd == pd, (key, rd, pd)
        assert rb.shape == pb.shape, (key, rb.shape, pb.shape)
        np.testing.assert_array_equal(rb, pb, err_msg=key)


def _write(path, *, quantize=True, quant_type=gguf.GGML_Q8_0, llama=False):
    cfg = tiny_config()
    tensors = tiny_tensors(cfg, seed=3)
    extra = None
    if llama:
        d = cfg.decoder
        qperm = names.llama_permute_rows(d.head_count * d.key_length, d.head_count)
        kperm = names.llama_permute_rows(d.head_count_kv * d.key_length, d.head_count_kv)
        hperm = names.llama_permute_head_dim(d.key_length)
        for i in range(d.block_count):
            p = f"blk.{i}."
            tensors[p + "attn_q.weight"] = tensors[p + "attn_q.weight"][qperm]
            tensors[p + "attn_k.weight"] = tensors[p + "attn_k.weight"][kperm]
            tensors[p + "attn_q_norm.weight"] = (tensors[p + "attn_q_norm.weight"] + 0.01 * np.arange(d.key_length))[hperm]
            tensors[p + "attn_k_norm.weight"] = tensors[p + "attn_k_norm.weight"][hperm]
        extra = {"qwen3asr.rope_permutation": "llama"}
    tokens, types = tiny_vocab()
    meta = {"tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.merges": [], "tokenizer.chat_template": "{audio}"}
    write_model(str(path), cfg, tensors, meta, quantize=quantize, extra_metadata=extra, quant_type=quant_type)
    return str(path)


@pytest.mark.parametrize(
    "kind", ["q8_0", "q4_0", "dense", "q8_0_llama", "dense_llama", "precise"]
)
def test_trees_bit_identical_to_reference(tmp_path, kind):
    path = _write(
        tmp_path / f"{kind}.gguf",
        quantize=not kind.startswith("dense"),
        quant_type=gguf.GGML_Q4_0 if kind == "q4_0" else gguf.GGML_Q8_0,
        llama=kind.endswith("llama"),
    )
    precise = kind == "precise"
    ref = RefWeights(path, precise=precise)
    port = Qwen3ASRWeights(path, device="cpu", precise=precise)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)  # the port keeps its own config class
    assert port.tokenizer.tokens == ref.tokenizer.tokens
    assert set(port.load_timings) == {"parse_s", "host_prep_s", "device_upload_s"}
    ref_dec = jax.tree.map(np.asarray, ref.decoder_params)
    ref_enc = jax.tree.map(np.asarray, ref.encoder_params)
    _assert_same_trees(ref_dec, port.decoder_params)
    _assert_same_trees(ref_enc, port.encoder_params)
    enc, dec = params_from_numpy(ref_enc, ref_dec, device="cpu")
    _assert_same_trees(ref_dec, dec)
    _assert_same_trees(ref_enc, enc)


def test_vocab_rows_padded_to_1024():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        w = Qwen3ASRWeights(_write(os.path.join(d, "m.gguf")), device="cpu")
    rows = w.decoder_params["embed"]["q"].shape[0]
    assert rows % 1024 == 0 and rows >= w.config.decoder.vocab_size
    assert not w.decoder_params["embed"]["q"][w.config.decoder.vocab_size:].any()


def test_scale_conversion_rounds_to_nearest_even_bitwise():
    """f16 → bf16 in torch equals the reference's host conversion on every
    finite f16 value, ties included."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    f16 = bits.view(np.float16)
    f16 = f16[np.isfinite(f16)]
    want = f16.astype(ml_dtypes.bfloat16).view(np.int16)
    got = to_bf16(f16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want)


def test_params_from_numpy_drops_tpu_only_scales():
    s = np.zeros((2, 4, 1), dtype=ml_dtypes.bfloat16)
    enc, dec = params_from_numpy({}, {"layers": {"qkv": {"q": np.zeros((2, 4, 32), np.int8), "s": s,
                                                         "s_t": s.transpose(0, 2, 1)}}})
    assert set(dec["layers"]["qkv"]) == {"q", "s"}
    assert dec["layers"]["qkv"]["s"].dtype == torch.bfloat16


def test_cuda_device_without_a_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel

    with pytest.raises(RuntimeError, match="CUDA"):
        Qwen3ASRModel(_write(tmp_path / "m.gguf"), device="cuda")

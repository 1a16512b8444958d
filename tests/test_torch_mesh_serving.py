"""The port's multi-device serving over gloo, against one process and the
reference's unsharded model.

Two process groups on the CPU, each over a ``FileStore`` under ``tmp_path``
with a 60 s timeout, joined with a timeout (as ``test_torch_parallel.py``):

- four ranks: ``Qwen3ASRModel(mesh=)`` on a dp2 × tp2 mesh (``transcribe``, a
  fresh then an extending interim tick, ``transcribe_batch`` of three
  streams, precise ``transcribe``), the Q8 tick at tp=2 (a smoke: its tokens
  and where they part from one process are printed), tp=4 refused (the
  fixture has 2 KV heads), the dp-split batch at dp=4, the sequence-parallel
  encoder at sp=4, and a model whose encoder heads tp=4 does not divide;
- two ranks: the serving legs on dp1 × tp2, the dp-split batch at dp=2 and the
  encoder at sp=2.

Every rank's tokens must equal every other's and the port's on one process
(dense tiny fixture: the reference's own tests hold its tp model to its
one-device model there). The port on one process must equal the reference's
unsharded model, or part from it only at a model-level near-tie: at the first
step where they part, the port's stateless top-2 logit gap lies under one
bf16 ulp of its top logit, where the two packages' bf16 roundings may order
two logits either way (the extending tick's window here parts the two
packages' stateless ``transcribe`` at step 2, gap 4.0e-3 at logits of 1.03,
whose ulp is 7.8e-3). Each parting is printed. The reference's
sharded programs are never run: they take tens of minutes of XLA CPU
compiles; the reference's ``Qwen3ASRModel(mesh=)`` is only built where it
refuses before compiling anything.

Run as a script, this file is one rank (``python test_torch_mesh_serving.py
DIR RANK WORLD``): that part imports no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script: the port is imported from the checkout
    sys.path.insert(0, REPO)

from light_whisper_tpu_torch.models.qwen3_asr.model import Qwen3ASRModel  # noqa: E402
from light_whisper_tpu_torch.parallel import train  # noqa: E402

SR = 16000
MAX_NEW = 8
TICK_MAX_NEW = 6
SP_CHUNKS = 8
WORKER_TIMEOUT_S = 150
SERVING = ("transcribe", "tick_fresh", "tick_extend", "batch", "precise")


# -- the inputs (the reference's test recipes) ----------------------------------


def clip():
    return (np.random.default_rng(0).standard_normal(8000) * 0.3).astype(np.float32)


def tick_windows():
    audio = (np.random.default_rng(7).standard_normal(2 * SR) * 0.1).astype(np.float32)
    return audio[: SR + 8000], audio[: SR + 16000]


def streams():
    rng = np.random.default_rng(1)
    return [(rng.standard_normal(8000 + 2000 * i) * 0.3).astype(np.float32) for i in range(3)]


def sp_mel(acfg):
    mel = np.random.default_rng(0).standard_normal((SP_CHUNKS * acfg.chunk_frames, acfg.num_mel_bins))
    return mel.astype(np.float32), SP_CHUNKS * acfg.tokens_per_chunk - 3


def ticks(model, incremental_module):
    inc = incremental_module.IncrementalTranscriber(model, max_new_tokens=TICK_MAX_NEW)
    fresh, extend = (inc.transcribe_window(w, 0).tokens for w in tick_windows())
    return fresh, extend, inc.incremental_prefills


def parting(port_model, audio, port, ref):
    """(step, top-2 gap, one bf16 ulp of the top logit) of the port's
    stateless logits where ``port`` and ``ref`` first part."""
    step = next((i for i, (a, b) in enumerate(zip(port, ref)) if a != b), min(len(port), len(ref)))
    logits = port_model.teacher_forced_logits(audio, port[:step])[step][: port_model.config.decoder.vocab_size]
    top2 = torch.topk(logits.float(), 2).values
    ulp = float(torch.finfo(torch.bfloat16).eps) * 2.0 ** float(torch.floor(torch.log2(top2[0].abs())))
    return step, float(top2[0] - top2[1]), ulp


def serving_tokens(model_cls, incremental_module, dense_path, **kw):
    """The five serving results of one package's model class on the dense
    fixture (``kw``: ``mesh=``, ``device=``)."""
    model = model_cls(dense_path, max_new_tokens=MAX_NEW, **kw)
    out = {"transcribe": model.transcribe(clip()).tokens,
           "batch": [r.tokens for r in model.transcribe_batch(streams())]}
    tick_model = model_cls(dense_path, max_new_tokens=TICK_MAX_NEW, **kw)
    out["tick_fresh"], out["tick_extend"], out["incremental_prefills"] = ticks(tick_model, incremental_module)
    out["precise"] = model_cls(dense_path, max_new_tokens=MAX_NEW, precise=True, **kw).transcribe(clip()).tokens
    return out


# -- the worker -------------------------------------------------------------------


def worker(directory: str, rank: int, world: int) -> None:
    import torch.distributed as dist

    from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights
    from light_whisper_tpu_torch.parallel import dryrun, encoder_sp
    from light_whisper_tpu_torch.parallel import mesh as pmesh
    from light_whisper_tpu_torch.serving import incremental

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    pmesh.init_distributed("cpu", rank, world, store=store, timeout_s=60)
    dense, q8 = os.path.join(directory, "dense.gguf"), os.path.join(directory, "q8.gguf")
    res = {}
    try:
        # tp=2 serving: dp2 x tp2 on four ranks, dp1 x tp2 on two
        mesh = pmesh.make_mesh(dp=world // 2, tp=2, device_type="cpu")
        res[f"dp{world // 2}xtp2"] = dryrun.same_on_every_rank(
            serving_tokens(Qwen3ASRModel, incremental, dense, mesh=mesh), "the tp serving tokens")
        if world == 4:
            q8_model = Qwen3ASRModel(q8, max_new_tokens=TICK_MAX_NEW, mesh=mesh)
            res["q8_tick"] = dryrun.same_on_every_rank(list(ticks(q8_model, incremental)), "the Q8 tick")
            try:
                Qwen3ASRModel(dense, mesh=pmesh.make_mesh(dp=1, tp=4, device_type="cpu"))
            except ValueError as exc:
                res["tp4_error"] = str(exc)
            enc6 = Qwen3ASRModel(os.path.join(directory, "enc6.gguf"), max_new_tokens=MAX_NEW,
                                 mesh=pmesh.make_mesh(dp=1, tp=4, device_type="cpu"))
            res["enc6_tp4"] = dryrun.same_on_every_rank(enc6.transcribe(clip()).tokens, "the enc6 tokens")
            res["enc6_encoder_sharded"] = enc6.encoder_tp is enc6.tp
        # the dp-split batch over every rank
        dp_mesh = pmesh.make_mesh(dp=world, tp=1, device_type="cpu")
        dp_model = Qwen3ASRModel(dense, max_new_tokens=MAX_NEW, mesh=dp_mesh)
        res[f"dp{world}"] = dryrun.same_on_every_rank(
            [r.tokens for r in dryrun.transcribe_batch_dp(dp_model, streams(), dp_mesh)], "the dp batch")
        # the sequence-parallel encoder over every rank
        sp_mesh = encoder_sp.make_sp_mesh(world, device_type="cpu")
        weights = Qwen3ASRWeights(dense)
        acfg = weights.config.audio
        mel, valid = sp_mel(acfg)
        params = encoder_sp.replicate_params(weights.encoder_params, sp_mesh)
        res[f"sp{world}"] = encoder_sp.encode_chunks_sp(acfg, params, torch.from_numpy(mel), valid, SP_CHUNKS,
                                                        sp_mesh)
        try:
            encoder_sp.encode_chunks_sp(acfg, params, torch.from_numpy(mel[: 7 * acfg.chunk_frames]), valid, 7,
                                        sp_mesh)
        except ValueError as exc:
            res[f"sp{world}_error"] = str(exc)
        torch.save(res, os.path.join(directory, f"out-{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the parent ---------------------------------------------------------------------


def enc6_config(cfg):
    """The fixture with 8 query heads over 4 KV heads of 8 (tp=4 divides them)
    and an encoder 96 wide with 6 heads (tp=4 divides its 96 columns, not
    its heads)."""
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, head_count=8, head_count_kv=4, key_length=8),
        audio=dataclasses.replace(cfg.audio, d_model=96, head_count=6))


def _write_fixtures(directory):
    from helpers.tiny_model import tiny_config, tiny_tensors, tiny_vocab, write_tiny_model
    from light_whisper_tpu.models.qwen3_asr.export import write_model

    write_tiny_model(os.path.join(directory, "dense.gguf"), quantize=False)
    write_tiny_model(os.path.join(directory, "q8.gguf"), quantize=True)
    cfg = enc6_config(tiny_config())
    tokens, types = tiny_vocab()
    meta = {"tokenizer.ggml.tokens": tokens, "tokenizer.ggml.token_type": types, "tokenizer.ggml.merges": [],
            "tokenizer.chat_template": "<|im_start|>user\n{audio}<|im_end|>\n<|im_start|>assistant\n"}
    write_model(os.path.join(directory, "enc6.gguf"), cfg, tiny_tensors(cfg, 0), meta, quantize=False)


def _spawn(directory, world):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(directory), str(r), str(world)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _join(directory, procs):
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank of a world-{len(procs)} group did not finish in {WORKER_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {len(procs)} exited {p.returncode}:\n{log[-3000:]}"
    return torch.load(os.path.join(directory, "out-0.pt"), weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' results (rank 0's; every rank's were held equal in the
    workers), the port's one-process results and the reference's unsharded
    ones. The groups run while this process computes the other two."""
    from light_whisper_tpu.models.qwen3_asr.encoder import encode_chunks as ref_encode_chunks
    from light_whisper_tpu.models.qwen3_asr.loader import Qwen3ASRWeights as RefWeights
    from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
    from light_whisper_tpu.serving import incremental as ref_incremental
    from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode_chunks
    from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights
    from light_whisper_tpu_torch.serving import incremental

    import jax.numpy as jnp

    dirs = {world: tmp_path_factory.mktemp(f"mesh{world}") for world in (4, 2)}
    _write_fixtures(dirs[4])
    for name in ("dense.gguf", "q8.gguf"):
        (dirs[2] / name).write_bytes((dirs[4] / name).read_bytes())
    procs = {world: _spawn(d, world) for world, d in dirs.items()}
    try:
        dense = str(dirs[4] / "dense.gguf")
        port = serving_tokens(Qwen3ASRModel, incremental, dense, device="cpu")
        port["q8_tick"] = list(ticks(Qwen3ASRModel(str(dirs[4] / "q8.gguf"), device="cpu",
                                                   max_new_tokens=TICK_MAX_NEW), incremental))
        port["enc6"] = Qwen3ASRModel(str(dirs[4] / "enc6.gguf"), device="cpu",
                                     max_new_tokens=MAX_NEW).transcribe(clip()).tokens
        weights = Qwen3ASRWeights(dense)
        mel, valid = sp_mel(weights.config.audio)
        port["encode"] = encode_chunks(weights.config.audio, weights.encoder_params, torch.from_numpy(mel), valid,
                                       SP_CHUNKS)

        mp = pytest.MonkeyPatch()
        mp.setenv("LWT_LOAD_OVERLAP_WARMUP", "0")
        try:
            ref = serving_tokens(RefModel, ref_incremental, dense)
            ref["enc6"] = RefModel(str(dirs[4] / "enc6.gguf"), max_new_tokens=MAX_NEW).transcribe(clip()).tokens
            ref_weights = RefWeights(dense)
            ref["encode"] = np.asarray(ref_encode_chunks(ref_weights.config.audio, ref_weights.encoder_params,
                                                         jnp.asarray(mel), jnp.int32(valid), SP_CHUNKS))
            ref["tp4_error"] = _reference_refusal(dense)
        finally:
            mp.undo()
        partings = {}
        inputs = {"transcribe": (False, MAX_NEW, clip()), "precise": (True, MAX_NEW, clip()),
                  "tick_fresh": (False, TICK_MAX_NEW, tick_windows()[0]),
                  "tick_extend": (False, TICK_MAX_NEW, tick_windows()[1])}
        for what, (precise, max_new, audio) in inputs.items():
            if port[what] != ref[what]:
                model = Qwen3ASRModel(dense, device="cpu", max_new_tokens=max_new, precise=precise)
                # a tick is the stateless transcribe of its window (the session's guarantee)
                assert model.transcribe(audio).tokens == port[what]
                partings[what] = parting(model, audio, port[what], ref[what])
    except BaseException:
        for group in procs.values():
            for p in group:
                p.kill()
        raise
    mesh = {}
    for world, d in dirs.items():
        mesh.update(_join(d, procs[world]))
    return {"mesh": mesh, "port": port, "ref": ref, "valid": valid, "partings": partings}


def _reference_refusal(path):
    """The reference's ``Qwen3ASRModel(mesh=)`` at tp=4 over 2 KV heads: it
    refuses before it compiles anything."""
    from light_whisper_tpu.models.qwen3_asr.model import Qwen3ASRModel as RefModel
    from light_whisper_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError) as exc:
        RefModel(path, mesh=make_mesh(dp=2, tp=4))
    return str(exc.value)


# -- the tests ----------------------------------------------------------------------------


@pytest.mark.parametrize("what", SERVING)
@pytest.mark.parametrize("mesh", ["dp2xtp2", "dp1xtp2"])
def test_tp_serving_matches_one_process_and_the_reference(runs, mesh, what):
    got, port, ref = runs["mesh"][mesh][what], runs["port"][what], runs["ref"][what]
    assert got == port, f"{what} on {mesh}: {got} != one process {port}"
    if port != ref:
        assert what in runs["partings"], f"{what}: the port on one process {port} != the reference {ref}"
        step, gap, ulp = runs["partings"][what]
        print(f"{what}: the port {port} parts from the reference {ref} at step {step}, "
              f"stateless top-2 gap {gap:.3g} (one bf16 ulp there {ulp:.3g})")
        assert port[:step] == ref[:step] and gap < ulp, (step, gap, ulp)
    if what.startswith("tick"):
        assert runs["mesh"][mesh]["incremental_prefills"] >= 1, "the extending tick did not extend"


def test_tp4_refuses_two_kv_heads_as_the_reference_does(runs):
    assert runs["mesh"]["tp4_error"] == runs["ref"]["tp4_error"] == "tp=4 must divide kv heads 2"


def test_q8_tp_tick_runs(runs):
    got, one = runs["mesh"]["q8_tick"], runs["port"]["q8_tick"]
    assert got[2] >= 1 and all(isinstance(t, int) for t in got[0] + got[1])
    for name, a, b in (("fresh", one[0], got[0]), ("extending", one[1], got[1])):
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        print(f"Q8 tp=2 {name} tick: {b} (one process {a}; {'identical' if a == b else f'parts at {step}'})")


def test_an_encoder_whose_heads_tp_does_not_divide_is_served_whole(runs):
    """tp=4 divides the decoder's 4 KV heads and the encoder's 96 columns but
    not its 6 heads: the reference serves it (GSPMD cuts a head in two), so
    the port does too, with the encoder whole on every rank."""
    assert runs["mesh"]["enc6_encoder_sharded"] is False
    assert runs["port"]["enc6"] == runs["ref"]["enc6"]
    assert runs["mesh"]["enc6_tp4"] == runs["port"]["enc6"]


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_split_batch_matches_the_batch(runs, dp):
    assert runs["mesh"][f"dp{dp}"] == runs["port"]["batch"] == runs["ref"]["batch"]


@pytest.mark.parametrize("sp", [2, 4])
def test_sequence_parallel_encoder_matches_one_device(runs, sp):
    valid = runs["valid"]
    got = runs["mesh"][f"sp{sp}"].float().numpy()
    port = runs["port"]["encode"].float().numpy()
    ref = runs["ref"]["encode"].astype(np.float32)
    assert got.shape == port.shape == ref.shape
    # the same function: equal to one device here (rows computed apart), and
    # within the reference test's 2e-2 of the reference
    np.testing.assert_array_equal(got[:valid], port[:valid])
    np.testing.assert_allclose(got[:valid], ref[:valid], rtol=2e-2, atol=2e-2)
    assert runs["mesh"][f"sp{sp}_error"] == f"num_chunks=7 not divisible by sp={sp}"


def test_q8_serving_trees_are_cut_by_the_linear_that_holds_each_leaf(tmp_path):
    """The loader's Q8_0 trees at tp=2: row-parallel o/down/fc2 cut along
    their in-features (quants and scales alike), column-parallel ones along
    their out-features by head group, the embedding whole; merging the
    shards gives the tree back. The reference's spec rule names a Q8 ``o/q``
    by its key ``q`` (out-features), which is only a placement for GSPMD."""
    from helpers.tiny_model import write_tiny_model
    from light_whisper_tpu_torch.models.qwen3_asr.loader import Qwen3ASRWeights
    from light_whisper_tpu_torch.parallel import sharding

    path = str(tmp_path / "q8.gguf")
    write_tiny_model(path, quantize=True)
    w = Qwen3ASRWeights(path)
    d = w.config.decoder
    shards = [sharding.shard_tree(w.decoder_params, r, 2, d) for r in range(2)]
    layers, whole = shards[1]["layers"], w.decoder_params["layers"]
    assert layers["o"]["q"].shape == (d.block_count, d.embedding_length, d.head_count * d.key_length // 2)
    assert layers["o"]["s"].shape == (d.block_count, d.embedding_length, d.head_count * d.key_length // 64)
    assert torch.equal(layers["down"]["q"], whole["down"]["q"][..., d.feed_forward_length // 2:])
    assert layers["qkv"]["q"].shape[1] == (d.head_count + 2 * d.head_count_kv) * d.key_length // 2
    assert shards[1]["embed"]["q"] is w.decoder_params["embed"]["q"]
    merged = sharding.merge_shards(shards, d)
    assert all(torch.equal(a, b) for a, b in zip(train.tree_leaves(merged), train.tree_leaves(w.decoder_params)))
    enc = sharding.shard_tree(w.encoder_params, 0, 2)["layers"]
    assert enc["fc2"]["q"].shape[-1] == w.config.audio.feed_forward_length // 2
    assert enc["q"]["b"].shape[-1] == w.config.audio.d_model // 2 and enc["o"]["b"].shape[-1] == w.config.audio.d_model
    assert sharding.param_specs(w.decoder_params)["layers"]["o"]["q"] == (None, "tp", None)
    with pytest.raises(ValueError, match="in/tp must be a multiple of 32"):
        sharding.shard_tree(w.decoder_params, 0, 4, d)  # o: 64 in-features over 4


def test_serving_config_checks_what_the_reference_checks():
    from helpers.tiny_model import tiny_config
    from light_whisper_tpu_torch.parallel import sharding

    cfg = tiny_config()
    with pytest.raises(ValueError, match="tp=4 must divide kv heads 2"):
        sharding.serving_config(cfg, 4)
    rank, encoder_sharded = sharding.serving_config(cfg, 2)
    assert (rank.decoder.head_count, rank.decoder.head_count_kv, rank.decoder.feed_forward_length) == (2, 1, 64)
    assert encoder_sharded and rank.audio.head_count == 2
    rank, encoder_sharded = sharding.serving_config(enc6_config(cfg), 4)
    assert not encoder_sharded and rank.audio == enc6_config(cfg).audio and rank.decoder.head_count_kv == 1
    with pytest.raises(ValueError, match="must divide the encoder heads"):
        sharding.local_config(enc6_config(cfg), 4)  # training keeps the strict check


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

"""The port's dp × tp train step over gloo, against the single-process step.

Four processes (dp2 × tp2) and two (tp2 alone) take one step of
``parallel.train`` on a tiny f32 model; their loss and their gradients,
gathered over ``tp`` with ``sharding.merge_shards``, must equal one process's
step within f32 reduction noise: loss within 1e-6 relative, every gradient
leaf within 1e-5 relative L2 (below 1e-3 of the whole gradient's norm, of
that; the ranks sum the row-parallel outputs and the
data shards' gradients in another order). The two examples hold 6 and 2
labels, so dp's ranks hold unequal label counts, where a mean of per-rank
means parts from the token-weighted mean (the test shows by how much).

Every process joins a ``FileStore`` under ``tmp_path`` (no TCP port for
pytest-xdist's workers to collide on) with a 60 s timeout, and the test waits
for each with a timeout and fails on it.

Run as a script, this file is that worker (``python test_torch_parallel.py
DIR RANK WORLD DP TP``); it and the case below import no JAX, so
``test_torch_train.py`` shares the case.
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

from light_whisper_tpu_torch.models.qwen3_asr import config as port_config  # noqa: E402
from light_whisper_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from light_whisper_tpu_torch.parallel import checkpoint, sharding, train  # noqa: E402

# -- the tiny fine-tuning case (also test_torch_train.py's) ------------------
# The reference's test_train_step_loss_decreases widths: decoder 64 wide, two
# layers, 8 query and 4 KV heads of 8; encoder 64 wide, one layer, 8 heads.

PREFIX = 2
LABELS = (6, 2)  # label tokens of each example: unequal over dp
DECODER = dict(vocab_size=256, embedding_length=64, block_count=2, feed_forward_length=128, head_count=8,
               head_count_kv=4, key_length=8, context_length=256)
AUDIO = dict(num_mel_bins=128, d_model=64, block_count=1, head_count=8, feed_forward_length=128,
             downsample_hidden_size=16, output_dim=64, n_window=50, max_source_positions=32)
AUDIO_TOKEN_ID = 250
WORKER_TIMEOUT_S = 120


def case_config(module, compute_dtype: str = "bfloat16"):
    """The case's ``Qwen3ASRConfig`` from ``module`` (the port's config module
    or the reference's: the same dataclasses)."""
    return module.Qwen3ASRConfig(
        audio=module.AudioEncoderConfig(**AUDIO, compute_dtype=compute_dtype),
        decoder=module.DecoderConfig(**DECODER, compute_dtype=compute_dtype),
        audio_token_id=AUDIO_TOKEN_ID)


def refill(tree, rng, f32: bool):
    """Every float leaf drawn anew from ``rng``: matrices at their own scale,
    norms near 1, zero biases small (``__graft_entry__._random_params`` tiles
    one noise block, so its layers repeat each other and its norms and
    biases are constant: a head or layer mixed up would go unseen). ``f32``
    casts every float leaf to float32."""
    if isinstance(tree, dict):
        return {k: refill(tree[k], rng, f32) for k in sorted(tree)}
    a = np.asarray(tree)
    x = a.astype(np.float32)
    if x.std() > 0:
        new = rng.standard_normal(a.shape) * x.std()
    elif np.all(x == 1):
        new = 1.0 + 0.1 * rng.standard_normal(a.shape)
    else:
        new = 0.02 * rng.standard_normal(a.shape)
    return new.astype(np.float32 if f32 else a.dtype)


def case_batch(cfg, seed: int = 0):
    """(mel [2, one chunk, 128] f32, ids [2, T] int32, labels [2, T] int32)."""
    rng = np.random.default_rng(seed)
    n_audio = cfg.audio.tokens_per_chunk
    T = PREFIX + n_audio + max(LABELS)
    mel = rng.standard_normal((len(LABELS), cfg.audio.chunk_frames, cfg.audio.num_mel_bins)).astype(np.float32)
    ids = rng.integers(0, 200, size=(len(LABELS), T)).astype(np.int32)
    ids[:, PREFIX:PREFIX + n_audio] = AUDIO_TOKEN_ID
    labels = np.full((len(LABELS), T), train.IGNORE_LABEL, np.int32)
    for b, n in enumerate(LABELS):
        labels[b, T - n:] = rng.integers(0, 200, size=n)
    return mel, ids, labels


def rel_l2(got, want, floor: float = 0.0) -> float:
    """||got - want|| / max(||want||, floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), floor, 1e-30))


def grad_floor(leaves) -> float:
    """1e-3 of the whole gradient's L2 norm: the norm below which a leaf's
    gradient is held absolutely (the encoder's k bias has a zero gradient in
    exact arithmetic, since a softmax ignores a shift shared by all keys, so
    its computed gradient is rounding alone)."""
    return 1e-3 * float(np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2)) for g in leaves)))


def grads_of(state):
    return train.tree_map(state.params, lambda p: p.grad.detach().clone())


# -- the worker ---------------------------------------------------------------


def worker(directory: str, rank: int, world: int, dp: int, tp: int) -> None:
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=True)
    cfg = case_config(port_config, "float32")
    store = torch.distributed.FileStore(os.path.join(directory, "store"), world)
    port_mesh.init_distributed("cpu", rank, world, store=store, timeout_s=60)
    try:
        mesh = port_mesh.make_mesh(dp, tp, device_type="cpu")
        state = train.init_state(mesh, inputs["encoder"], inputs["decoder"], train.adam(1e-3), cfg, device="cpu")
        step, place = train.make_train_step(cfg, mesh, PREFIX, device="cpu")
        state, loss = step(state, *place(inputs["mel"], inputs["ids"], inputs["labels"]))
        # every rank saves its slice; each restores its own into a fresh state on the same mesh
        ckpt = os.path.join(directory, "ckpt")
        checkpoint.save_train_state(ckpt, state)
        template = train.init_state(mesh, inputs["encoder"], inputs["decoder"], train.adam(1e-3), cfg, device="cpu")
        restored = checkpoint.restore_train_state(ckpt, template)
        torch.save({"loss": loss, "grads": grads_of(state), "dp_rank": mesh.get_local_rank("dp"),
                    "tp_rank": mesh.get_local_rank("tp"), "restored_equal": checkpoint.tree_equal(restored, state)},
                   os.path.join(directory, f"out-{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# -- the tests ----------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    """f32 parameters and the batch, and one process's step on them."""
    import __graft_entry__ as graft
    from light_whisper_tpu.models.qwen3_asr import config as ref_config

    enc, dec = graft._random_params(case_config(ref_config), seed=3, device=False)
    rng = np.random.default_rng(3)
    enc, dec = refill(enc, rng, f32=True), refill(dec, rng, f32=True)
    enc_t = train.tree_map(enc, torch.from_numpy)
    dec_t = train.tree_map(dec, torch.from_numpy)
    mel, ids, labels = (torch.from_numpy(a) for a in case_batch(case_config(port_config)))
    cfg = case_config(port_config, "float32")
    state = train.init_state(None, enc_t, dec_t, train.adam(1e-3), cfg, device="cpu")
    step, place = train.make_train_step(cfg, None, PREFIX, device="cpu")
    state, loss = step(state, *place(mel, ids, labels))
    return {"encoder": enc_t, "decoder": dec_t, "mel": mel, "ids": ids, "labels": labels,
            "loss": float(loss), "grads": grads_of(state)}


def _run_workers(tmp_path, case, dp: int, tp: int):
    torch.save({k: case[k] for k in ("encoder", "decoder", "mel", "ids", "labels")}, tmp_path / "inputs.pt")
    world = dp * tp
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(tmp_path), str(r), str(world),
                               str(dp), str(tp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a dp{dp} x tp{tp} worker did not finish in {WORKER_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    return [torch.load(tmp_path / f"out-{r}.pt", weights_only=True) for r in range(world)]


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 2)], ids=["dp2xtp2", "tp2"])
def test_mesh_step_equals_the_single_process_step(tmp_path, case, dp, tp):
    outs = _run_workers(tmp_path, case, dp, tp)
    world = dp * tp
    assert sorted(os.listdir(tmp_path / "ckpt")) == [f"shard-{r}-of-{world}.pt" for r in range(world)]
    assert all(o["restored_equal"] for o in outs)
    cfg = case_config(port_config, "float32")
    worst_loss = max(abs(float(o["loss"]) - case["loss"]) / abs(case["loss"]) for o in outs)
    worst_grad, worst_leaf = 0.0, None
    for d in range(dp):
        ranks = sorted((o for o in outs if o["dp_rank"] == d), key=lambda o: o["tp_rank"])
        merged = sharding.merge_shards([o["grads"] for o in ranks], cfg.decoder)
        floor = grad_floor(train.tree_leaves(case["grads"]))
        for name in ("encoder", "decoder"):
            want = train.tree_leaves(case["grads"][name])
            got = train.tree_leaves(merged[name])
            assert [g.shape for g in got] == [w.shape for w in want]
            for i, (g, w) in enumerate(zip(got, want)):
                err = rel_l2(g, w, floor)
                if err > worst_grad:
                    worst_grad, worst_leaf = err, f"{name}[{i}] {tuple(w.shape)}"
    print(f"dp{dp} x tp{tp}: loss {case['loss']:.6f}, worst rel loss error {worst_loss:.3g} (tol 1e-6), "
          f"worst gradient rel L2 {worst_grad:.3g} at {worst_leaf} (tol 1e-5)")
    assert worst_loss <= 1e-6
    assert worst_grad <= 1e-5

    if dp > 1:
        # the case discriminates: each rank's own mean, averaged, is another loss
        per_rank = []
        for b in range(len(LABELS)):
            one = train.asr_loss(cfg, {"encoder": case["encoder"], "decoder": case["decoder"]},
                                 case["mel"][b:b + 1], case["ids"][b:b + 1].long(), case["labels"][b:b + 1].long(),
                                 PREFIX)
            per_rank.append(float(one))
        mean_of_means = sum(per_rank) / len(per_rank)
        print(f"per-rank means {per_rank}: their mean {mean_of_means:.6f} vs the token-weighted {case['loss']:.6f}")
        assert abs(mean_of_means - case["loss"]) > 1e3 * 1e-6 * abs(case["loss"])


def test_tp_must_divide_the_kv_heads():
    cfg = case_config(port_config)
    with pytest.raises(ValueError, match="must divide kv heads 4"):
        sharding.local_config(cfg, 3)
    with pytest.raises(ValueError, match="must divide the encoder heads"):
        sharding.local_config(dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio, head_count=6)), 4)
    qkv = {"layers": {"qkv": {"w": torch.zeros(2, 64, 128)}}}
    with pytest.raises(ValueError, match="does not split over tp=3"):
        sharding.shard_tree(qkv, 0, 3, cfg.decoder)
    assert sharding.local_config(cfg, 2).decoder.head_count_kv == 2


def test_param_specs_match_the_reference():
    """The reference's Megatron cases (tests/test_parallel.py) and every leaf
    of the case's real trees get the reference's spec."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from light_whisper_tpu.models.qwen3_asr import config as ref_config
    from light_whisper_tpu.parallel.sharding import param_specs as ref_specs

    megatron = {
        "layers": {
            "q": {"w": np.zeros((2, 8, 16), np.float32)},
            "o": {"w": np.zeros((2, 16, 8), np.float32)},
            "gate": {"q": np.zeros((2, 32, 8), np.int8), "s": np.zeros((2, 32, 1), np.float32)},
            "attn_norm": np.zeros((2, 8), np.float32),
        },
        "final_norm": np.zeros(8, np.float32),
    }
    got = sharding.param_specs(megatron)
    assert got["layers"]["q"]["w"] == (None, None, "tp")
    assert got["layers"]["o"]["w"] == (None, "tp", None)
    assert got["layers"]["gate"]["q"] == (None, "tp", None)
    assert got["layers"]["gate"]["s"] == (None, "tp", None)
    assert got["layers"]["attn_norm"] == ()
    assert got["final_norm"] == ()

    enc, dec = graft._random_params(case_config(ref_config), seed=0, device=False)
    for tree in (megatron, enc, dec):
        want = jax.tree.leaves(ref_specs(jax.tree.map(jnp.asarray, tree)),
                               is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        mine = jax.tree.leaves(sharding.param_specs(tree), is_leaf=lambda x: isinstance(x, tuple))
        assert [tuple(s) for s in want] == mine


def test_shards_hold_whole_heads_and_merge_back():
    """Rank r's qkv columns are q heads, k heads and v heads of its own group,
    its gateup columns the matching gate and up blocks; merging is exact."""
    cfg = case_config(port_config)
    d = cfg.decoder
    hd, Hq, Hkv, F = d.key_length, d.head_count, d.head_count_kv, d.feed_forward_length
    col = torch.arange((Hq + 2 * Hkv) * hd, dtype=torch.float32)
    tree = {"layers": {"qkv": {"w": col.expand(2, 4, -1).clone()},
                       "gateup": {"w": torch.arange(2 * F, dtype=torch.float32).expand(2, 4, -1).clone()}}}
    for tp in (1, 2, 4):
        shards = [sharding.shard_tree(tree, r, tp, d) for r in range(tp)]
        for r, s in enumerate(shards):
            q, k, v = torch.split(s["layers"]["qkv"]["w"][0, 0], [Hq * hd // tp, Hkv * hd // tp, Hkv * hd // tp])
            assert torch.equal(q, col[r * Hq * hd // tp:(r + 1) * Hq * hd // tp])
            assert torch.equal(k, col[Hq * hd + r * Hkv * hd // tp:Hq * hd + (r + 1) * Hkv * hd // tp])
            gate, up = torch.chunk(s["layers"]["gateup"]["w"][0, 0], 2)
            assert torch.equal(up - gate, torch.full_like(gate, F))
        merged = sharding.merge_shards(shards, d)
        assert all(torch.equal(a, b) for a, b in zip(train.tree_leaves(merged), train.tree_leaves(tree)))


def test_mesh_sizes_follow_the_reference():
    from light_whisper_tpu.parallel.mesh import make_mesh as ref_make_mesh

    for dp, tp in ((4, 2), (None, 8), (2, None), (None, None), (8, 1)):
        ref = ref_make_mesh(dp=dp, tp=tp)
        assert port_mesh.mesh_shape(dp, tp, 8) == (ref.shape["dp"], ref.shape["tp"])
    for dp, tp in ((3, 3), (3, None)):
        with pytest.raises(ValueError):
            ref_make_mesh(dp=dp, tp=tp)
        with pytest.raises(ValueError):
            port_mesh.mesh_shape(dp, tp, 8)


def test_backend_follows_the_device():
    assert port_mesh.backend_for("cpu") == "gloo"
    if torch.cuda.is_available():
        assert port_mesh.backend_for("cuda") == "nccl"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            port_mesh.backend_for("cuda")
    with pytest.raises(ValueError):
        port_mesh.backend_for("mps")
    with pytest.raises(RuntimeError, match="init_distributed"):
        port_mesh.make_mesh(1, 1, device_type="cpu")


if __name__ == "__main__":
    worker(sys.argv[1], *map(int, sys.argv[2:6]))

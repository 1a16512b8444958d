"""The port's GPipe pipeline (``parallel/pipeline.py``) over gloo, against the
unpipelined forward and its gradients on one process.

The reference's six pipeline tests (``tests/test_parallel.py``) as cases of
one four-rank group (a ``FileStore`` under ``tmp_path``, a 60 s timeout, a
timed join): the decoder of the reference's ``_tiny_pp_setup`` (64 wide,
8 layers, 8 query heads over 4 KV heads of 8, f32) on a pp=4 and on a dp2 ×
pp2 mesh. Every leaf is drawn anew (``test_torch_parallel.refill``), so a
layer placed on the wrong stage shows.

- the forward at pp=4 and pp=2 (M=5, T=12) and with fewer microbatches than
  stages (pp=4, M=2) equals ``forward_train`` of each microbatch within the
  reference's 2e-3;
- the gradients of the reference test's loss through the pipeline (pp=4, M=3)
  and on a dp2 × pp2 grid with a ``[M, B, T, D]`` batch (M=3, B=4, T=10) equal
  the unpipelined gradients within the reference's 5e-3;
- five Adam steps lower the loss;
- 6 layers over pp=4 raise.

``forward_train`` on one process is the port's, held against the reference's
here on the same parameters (the reference's pipelined programs are not run).

Run as a script, this file is one rank (``python test_torch_pipeline.py DIR
RANK WORLD``): that part imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script: the port is imported from the checkout
    sys.path.insert(0, REPO)

from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec  # noqa: E402
from light_whisper_tpu_torch.models.qwen3_asr.config import DecoderConfig  # noqa: E402
from light_whisper_tpu_torch.parallel import pipeline, train  # noqa: E402

WORLD = 4
WORKER_TIMEOUT_S = 120
DECODER = dict(vocab_size=256, embedding_length=64, block_count=8, feed_forward_length=128, head_count=8,
               head_count_kv=4, key_length=8, context_length=256, compute_dtype="float32")
TOL = 2e-3  # the reference's forward tolerance
GRAD_TOL = 5e-3  # the reference's gradient tolerance


def config(**kw) -> DecoderConfig:
    return DecoderConfig(**{**DECODER, **kw})


def inputs(seed: int, *shape):
    rng = np.random.default_rng(seed)
    embeds = torch.from_numpy(rng.standard_normal((*shape, DECODER["embedding_length"])).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, DECODER["vocab_size"], size=shape))
    return embeds, labels


CASES = {  # name: (dp, pp, seed, leading shape)
    "fwd_pp4": (1, 4, 11, (5, 12)),
    "fwd_pp4_m2": (1, 4, 12, (2, 12)),
    "fwd_pp2": (2, 2, 13, (5, 12)),
    "grad_pp4": (1, 4, 14, (3, 12)),
    "grad_dp2xpp2": (2, 2, 15, (3, 4, 10)),
}


# -- the worker ------------------------------------------------------------------


def worker(directory: str, rank: int, world: int) -> None:
    import torch.distributed as dist

    from light_whisper_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    params = torch.load(os.path.join(directory, "params.pt"), weights_only=True)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    pmesh.init_distributed("cpu", rank, world, store=store, timeout_s=60)
    cfg, res = config(), {}
    try:
        meshes = {pp: pipeline.make_pp_mesh(pp, dp=world // pp, device_type="cpu") for pp in (4, 2)}
        for name, (dp, pp, seed, shape) in CASES.items():
            mesh = meshes[pp]
            embeds, labels = inputs(seed, *shape)
            if name.startswith("fwd"):
                with torch.no_grad():
                    res[name] = pipeline.forward_train_pp(cfg, pipeline.place_decoder_params_pp(params, mesh),
                                                          embeds, mesh)
                continue
            placed = train.tree_map(pipeline.place_decoder_params_pp(params, mesh), lambda t: t.requires_grad_())
            loss = pipeline.backward_pp(cfg, placed, embeds, labels, mesh)
            res[name] = {"loss": loss, "stage": mesh.get_local_rank("pp"), "pp": pp,
                         "grads": train.tree_map(placed, lambda t: t.grad)}
        # five Adam steps at pp=4
        mesh = meshes[4]
        embeds, labels = inputs(16, 4, 12)
        state = pipeline.init_state_pp(mesh, params, train.adam(3e-3), cfg)
        step = pipeline.make_train_step_pp(cfg, mesh)
        res["losses"] = [float(step(state, embeds, labels)[1]) for _ in range(5)]
        try:
            pipeline.forward_train_pp(config(block_count=6), params, embeds, mesh)
        except ValueError as exc:
            res["indivisible"] = str(exc)
        torch.save(res, os.path.join(directory, f"out-{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the parent --------------------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(f32 parameters, every rank's results), the ranks run while this
    process computes the one-process references."""
    import __graft_entry__ as graft
    from light_whisper_tpu.models.qwen3_asr import config as ref_config
    from test_torch_parallel import refill

    ref_cfg = ref_config.Qwen3ASRConfig(
        audio=ref_config.AudioEncoderConfig(num_mel_bins=128, d_model=64, block_count=1, head_count=8,
                                            feed_forward_length=128, downsample_hidden_size=16, output_dim=64,
                                            n_window=50, max_source_positions=32),
        decoder=ref_config.DecoderConfig(**DECODER), audio_token_id=250)
    _enc, dec_np = graft._random_params(ref_cfg, seed=11, device=False)
    dec_np = refill(dec_np, np.random.default_rng(11), f32=True)
    params = train.tree_map(dec_np, torch.from_numpy)
    directory = tmp_path_factory.mktemp("pipeline")
    torch.save(params, directory / "params.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(directory), str(r), str(WORLD)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            logs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"a pipeline rank did not finish in {WORKER_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
    return params, dec_np, [torch.load(directory / f"out-{r}.pt", weights_only=True) for r in range(WORLD)]


def forward_each(params, embeds_mb):
    """``forward_train`` on one process, microbatch by microbatch (and example
    by example under a batch axis)."""
    with train.f32_matmuls():
        return torch.stack([dec.forward_train(config(), params, e) for e in embeds_mb])


def one_process_grads(params, embeds_mb, labels_mb):
    leaves = train.tree_map(params, lambda t: t.detach().clone().requires_grad_())
    with train.f32_matmuls():
        hidden = forward_each(leaves, embeds_mb)
        logits = dec.logits_for(config(), leaves, hidden)
        ll = torch.log_softmax(logits.float(), dim=-1).gather(-1, labels_mb[..., None])[..., 0]
        (-ll.sum() / labels_mb.numel()).backward()
    return train.tree_map(leaves, lambda t: t.grad)


@pytest.mark.parametrize("name", ["fwd_pp4", "fwd_pp4_m2", "fwd_pp2"])
def test_pipeline_forward_matches_single_device(run, name):
    params, _np, outs = run
    _dp, _pp, seed, shape = CASES[name]
    embeds, _labels = inputs(seed, *shape)
    want = forward_each(params, embeds)
    for r, out in enumerate(outs):  # replicated: every rank returns the whole output
        assert out[name].shape == want.shape
        np.testing.assert_allclose(out[name].numpy(), want.numpy(), rtol=TOL, atol=TOL, err_msg=f"rank {r}")


def test_one_process_forward_matches_the_reference(run):
    import jax
    import jax.numpy as jnp

    from light_whisper_tpu.models.qwen3_asr import config as ref_config
    from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec

    params, dec_np, _outs = run
    embeds, _labels = inputs(11, 1, 12)
    want = np.asarray(ref_dec.forward_train(ref_config.DecoderConfig(**DECODER), jax.tree.map(jnp.asarray, dec_np),
                                            jnp.asarray(embeds[0].numpy())))
    np.testing.assert_allclose(forward_each(params, embeds)[0].numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["grad_pp4", "grad_dp2xpp2"])
def test_pipeline_grads_match_single_device(run, name):
    params, _np, outs = run
    _dp, _pp, seed, shape = CASES[name]
    embeds, labels = inputs(seed, *shape)
    want = one_process_grads(params, embeds, labels)
    checked = 0
    for out in outs:
        got = out[name]
        n = DECODER["block_count"] // got["pp"]
        rows = slice(got["stage"] * n, (got["stage"] + 1) * n)
        for key in got["grads"]:
            for leaf_got, leaf_want, path in _pairs(got["grads"][key], want[key], key):
                if key == "layers":
                    leaf_want = leaf_want[rows]
                np.testing.assert_allclose(leaf_got.numpy(), leaf_want.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL,
                                           err_msg=path)
                checked += 1
    assert checked >= 10 * len(outs)
    assert len({float(out[name]["loss"]) for out in outs}) == 1


def _pairs(got, want, path):
    if isinstance(got, dict):
        for k in sorted(got):
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    else:
        yield got, want, path


def test_pipeline_train_step_loss_decreases(run):
    _params, _np, outs = run
    losses = outs[0]["losses"]
    assert all(out["losses"] == losses for out in outs)
    assert losses[-1] < losses[0], losses


def test_pipeline_rejects_indivisible_layers(run):
    _params, _np, outs = run
    assert all(out["indivisible"] == "block_count=6 not divisible by pp=4" for out in outs)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

"""The port's fine-tuning path against the JAX package's, on the CPU.

One tiny case (``test_torch_parallel.py``'s: the reference's
``test_train_step_loss_decreases`` widths, parameters of
``__graft_entry__._random_params``'s structure drawn anew from a seed, two
examples with 6 and 2 labels) goes through:

- ``decoder.forward_train`` against the reference's: f32 within 1e-5 of
  max|ref|, bf16 within 1e-2 relative L2 (bf16 activations through two
  layers, rounded in other orders: 6e-3 measured, a few values 2 ulps apart);
- ``train.asr_loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's (computed once a module): f32 loss within 1e-5 relative and every
  gradient leaf within 1e-4 relative L2 (a leaf whose gradient is under 1e-3
  of the whole gradient's norm is held to that norm: the encoder's k bias has
  a zero gradient in exact arithmetic); bf16 loss within 2e-3 and the whole
  gradient within 2e-2 relative L2, each leaf no farther from the exact
  gradient (f32 compute at the same bf16 values) than 1.25 × the reference's
  worst leaf is (the two packages round at the same points, in other orders:
  their deepest leaves part by ~2e-2, about as far as each sits from the
  exact gradient);
- one Adam and one AdamW step on f32 parameters against ``optax.adam`` and
  ``optax.adamw`` with the same hyper-parameters: within 1e-6 absolute;
- five train steps on one batch lower the loss (the reference's test);
- a checkpoint round trip is bitwise, and a run saved at step 2, restored and
  stepped equals an uninterrupted run bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from light_whisper_tpu.models.qwen3_asr import config as ref_config
from light_whisper_tpu.models.qwen3_asr import decoder as ref_dec
from light_whisper_tpu.parallel import train as ref_train
from light_whisper_tpu_torch.models.qwen3_asr import config as port_config
from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr.params import numpy_from_params, params_from_numpy
from light_whisper_tpu_torch.parallel import checkpoint, train
from test_torch_parallel import PREFIX, case_batch, case_config, grad_floor, refill, rel_l2

DTYPES = {"bf16": "bfloat16", "f32": "float32"}
TOL = {"bf16": {"loss": 2e-3, "grad": 2e-2}, "f32": {"loss": 1e-5, "grad": 1e-4}}


def _numpy_params(kind: str):
    enc, dec_p = graft._random_params(case_config(ref_config), seed=3, device=False)
    rng = np.random.default_rng(3)
    return refill(enc, rng, f32=kind == "f32"), refill(dec_p, rng, f32=kind == "f32")


@pytest.fixture(scope="module")
def reference():
    """Per dtype: the numpy parameters, the batch, and the reference's loss and
    gradients (one jit of ``value_and_grad(asr_loss)`` a dtype). For bf16 also
    ``exact``: the gradient at the same bf16 parameter values in f32 compute."""
    out = {}
    mel, ids, labels = case_batch(case_config(ref_config))
    fns = {kind: jax.jit(jax.value_and_grad(
        lambda p, cfg=case_config(ref_config, dtype): ref_train.asr_loss(
            cfg, p, jnp.asarray(mel), jnp.asarray(ids), jnp.asarray(labels), PREFIX)))
        for kind, dtype in DTYPES.items()}

    def run(kind, enc, dec_p):
        loss, grads = fns[kind](jax.tree.map(jnp.asarray, {"encoder": enc, "decoder": dec_p}))
        return float(loss), jax.tree.map(lambda g: np.asarray(g, np.float32), grads)

    for kind in DTYPES:
        enc, dec_p = _numpy_params(kind)
        loss, grads = run(kind, enc, dec_p)
        out[kind] = {"encoder": enc, "decoder": dec_p, "loss": loss, "grads": grads}
    f32 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    out["bf16"]["exact"] = run("f32", f32(out["bf16"]["encoder"]), f32(out["bf16"]["decoder"]))[1]
    out["batch"] = (mel, ids, labels)
    return out


def _port_params(ref, kind):
    enc, dec_p = params_from_numpy(ref[kind]["encoder"], ref[kind]["decoder"])
    return {"encoder": enc, "decoder": dec_p}


def _batch(ref):
    mel, ids, labels = ref["batch"]
    return torch.from_numpy(mel), torch.from_numpy(ids).long(), torch.from_numpy(labels).long()


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_forward_train_matches_the_reference(reference, kind):
    cfg_ref = case_config(ref_config, DTYPES[kind]).decoder
    cfg = case_config(port_config, DTYPES[kind]).decoder
    rng = np.random.default_rng(11)
    embeds = rng.standard_normal((19, cfg.embedding_length)).astype(np.float32)
    dec_p = reference[kind]["decoder"]
    dtype = jnp.float32 if kind == "f32" else jnp.bfloat16
    want = np.asarray(ref_dec.forward_train(cfg_ref, jax.tree.map(jnp.asarray, dec_p),
                                            jnp.asarray(embeds).astype(dtype)), np.float32)
    params = params_from_numpy({}, dec_p)[1]
    got = dec.forward_train(cfg, params, torch.from_numpy(embeds).to(dec.torch_dtype(cfg.compute_dtype)))
    got = got.float().numpy()
    peak = float(np.abs(want).max())
    err, rel = float(np.abs(got - want).max()), rel_l2(got, want)
    print(f"forward_train {kind}: max|Δh| {err:.3g} of max|h| {peak:.3g}, rel L2 {rel:.3g}")
    assert got.shape == want.shape
    if kind == "f32":
        assert err <= 1e-5 * peak
    else:
        assert rel <= 1e-2
    # batched rows are each row's own sequence
    both = dec.forward_train(cfg, params, torch.from_numpy(np.stack([embeds, embeds[::-1].copy()]))
                             .to(dec.torch_dtype(cfg.compute_dtype))).float().numpy()
    assert rel_l2(both[0], got) <= 1e-6


def _whole(leaves) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in leaves])


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_asr_loss_and_gradients_match_the_reference(reference, kind):
    ref = reference[kind]
    params = _port_params(reference, kind)
    for p in train.tree_leaves(params):
        p.requires_grad_()
    cfg = case_config(port_config, DTYPES[kind])
    with train.f32_matmuls():
        loss = train.asr_loss(cfg, params, *_batch(reference), PREFIX)
        loss.backward()
    loss = float(loss.detach())
    got = train.tree_leaves(numpy_from_params(train.tree_map(params, lambda p: p.grad)))
    want = train.tree_leaves(ref["grads"])
    floor = grad_floor(want)
    loss_err = abs(loss - ref["loss"]) / abs(ref["loss"])
    worst = max((rel_l2(g, w, floor), i, w.shape) for i, (g, w) in enumerate(zip(got, want)))
    whole = rel_l2(_whole(got), _whole(want))
    print(f"asr_loss {kind}: loss {loss:.6f} vs {ref['loss']:.6f} (rel {loss_err:.3g}, tol {TOL[kind]['loss']:g}); "
          f"gradient rel L2: whole {whole:.3g}, worst leaf {worst[0]:.3g} at {worst[1]} {worst[2]} "
          f"(tol {TOL[kind]['grad']:g})")
    assert loss_err <= TOL[kind]["loss"]
    if kind == "f32":
        assert worst[0] <= TOL[kind]["grad"]
        return
    # bf16: two roundings of one function. The whole gradient is held to the
    # tolerance; per leaf, the port must sit no farther from the exact gradient
    # (f32 compute at the same bf16 values) than the reference's worst leaf
    # does, with a quarter to spare (its deepest leaves part from the reference
    # by about what the reference's own part from the exact gradient).
    assert whole <= TOL[kind]["grad"]
    exact = train.tree_leaves(ref["exact"])
    mine = max(rel_l2(g, e, floor) for g, e in zip(got, exact))
    theirs = max(rel_l2(w, e, floor) for w, e in zip(want, exact))
    print(f"asr_loss bf16: worst leaf vs the exact gradient: port {mine:.3g}, reference {theirs:.3g}")
    assert mine <= 1.25 * theirs


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_one_optimizer_step_matches_optax(reference, name):
    ref = reference["f32"]
    lr = 1e-3
    tx = optax.adam(lr) if name == "adam" else optax.adamw(lr)
    params = {"encoder": ref["encoder"], "decoder": ref["decoder"]}
    jparams = jax.tree.map(jnp.asarray, params)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, ref["grads"]), tx.init(jparams), jparams)
    want = train.tree_leaves(jax.tree.map(np.asarray, optax.apply_updates(jparams, updates)))

    mine = _port_params(reference, "f32")
    leaves = train.tree_leaves(mine)
    opt = (train.adam(lr) if name == "adam" else train.adamw(lr)).build(leaves)
    for p, g in zip(leaves, train.tree_leaves(ref["grads"])):
        p.grad = torch.from_numpy(g.copy())
    opt.step()
    err = max(float(np.abs(p.detach().numpy() - w).max()) for p, w in zip(leaves, want))
    print(f"{name}: max |Δparam| after one step {err:.3g} (tol 1e-6)")
    assert err <= 1e-6


def test_train_step_loss_decreases(reference):
    """The reference's test in the port: five steps on one batch lower the loss."""
    params = _port_params(reference, "bf16")
    cfg = case_config(port_config)
    state = train.init_state(None, params["encoder"], params["decoder"], train.adam(3e-3), cfg, device="cpu")
    step, place = train.make_train_step(cfg, None, PREFIX, device="cpu")
    batch = place(*_batch(reference))
    losses = []
    for _ in range(5):
        state, loss = step(state, *batch)
        losses.append(float(loss))
    print(f"losses {losses}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 5


def _fresh_state(reference):
    params = _port_params(reference, "bf16")
    return train.init_state(None, params["encoder"], params["decoder"], train.adamw(1e-3),
                            case_config(port_config), device="cpu")


def test_checkpoint_round_trip_and_resume_are_bitwise(reference, tmp_path):
    cfg = case_config(port_config)
    step, place = train.make_train_step(cfg, None, PREFIX, device="cpu")
    batch = place(*_batch(reference))

    straight = _fresh_state(reference)
    for _ in range(3):
        straight, _loss = step(straight, *batch)

    resumed = _fresh_state(reference)
    for _ in range(2):
        resumed, _loss = step(resumed, *batch)
    path = str(tmp_path / "ckpt")
    checkpoint.save_train_state(path, resumed)
    checkpoint.save_train_state(path, resumed)  # a second commit replaces the first
    restored = checkpoint.restore_train_state(path, _fresh_state(reference))
    assert checkpoint.tree_equal(restored, resumed)
    assert not checkpoint.tree_equal(restored, _fresh_state(reference))
    restored, _loss = step(restored, *batch)
    assert restored.step == straight.step == 3
    assert checkpoint.tree_equal(restored, straight)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]

"""The ASR fine-tuning step over a (dp, tp) mesh (counterpart of
``parallel/train.py``).

Full encoder + decoder fine-tuning: data parallelism over ``dp`` (each rank
takes its slice of the batch, gradients summed over the ``dp`` group) and the
Megatron split over ``tp`` (``sharding``). The reference writes sharding
annotations and lets XLA derive the collectives; here they are written out,
and gradients come from autograd through plain PyTorch (the reference's
training path reaches no Pallas kernel either: its parameters are dense).

Three things differ in form, not in the function computed:

- the loss is the token-weighted mean over the whole batch,
  ``sum(losses) / max(1, sum(counts))``. Under ``dp`` the ranks' label counts
  are summed before the division and each rank's gradient of its own sum is
  summed after, which is that mean; averaging per-rank means (a data-parallel
  wrapper's default) would weigh a rank's tokens by how few it holds;
- the optimizer is PyTorch's (:func:`adam`, :func:`adamw`), built by
  :func:`init_state` over this rank's parameters and kept in the
  :class:`TrainState`, with optax's hyper-parameters stated (eps outside the
  square root in both; ``optax.adamw``'s weight decay is 1e-4, torch's
  default 1e-2). So :func:`make_train_step` takes no optimizer;
- the step updates the state in place (the reference donates it) and
  returns it.

TF32 is held off for the whole step, the backward included
(:func:`f32_matmuls`): the encoder's convolutions turn it off only while
they run forward, and their backward runs later, inside ``loss.backward()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr.config import Qwen3ASRConfig
from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode_chunks_batch
from light_whisper_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, mesh_device
from light_whisper_tpu_torch.parallel.sharding import TensorParallel, head_local_leaves, local_config, shard_params

IGNORE_LABEL = -100


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Adam (``weight_decay`` None) or AdamW with optax's conventions."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: Optional[float] = None

    def build(self, params: List[torch.Tensor]) -> torch.optim.Optimizer:
        if self.weight_decay is None:
            return torch.optim.Adam(params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps)
        return torch.optim.AdamW(params, lr=self.lr, betas=(self.b1, self.b2), eps=self.eps,
                                 weight_decay=self.weight_decay)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> OptimizerSpec:
    """``optax.adam``'s defaults."""
    return OptimizerSpec(lr, b1, b2, eps)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerSpec:
    """``optax.adamw``'s defaults (weight decay 1e-4 on every leaf)."""
    return OptimizerSpec(lr, b1, b2, eps, weight_decay)


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]  # {"encoder": ..., "decoder": ...}: this rank's slices, leaves require grad
    optimizer: torch.optim.Optimizer  # over tree_leaves(params); holds the moments
    step: int = 0


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict in sorted key order (the optimizer's and
    the checkpoint's parameter order)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(tree, fn):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


@contextlib.contextmanager
def f32_matmuls():
    """TF32 off for matmuls and cuDNN convolutions until the block ends."""
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def loss_terms(cfg: Qwen3ASRConfig, params: Dict[str, Any], mel: torch.Tensor, ids: torch.Tensor,
               labels: torch.Tensor, prefix_len: int, tp=dec.Replicated) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed negative log-likelihood of the label tokens, their count).

    ``mel [B, frames, mels]`` holds whole chunks; ``ids [B, T]`` the prompt and
    transcript with audio placeholders at ``prefix_len … prefix_len + n_audio``,
    whose rows take the encoder's output; ``labels [B, T]`` the next tokens,
    ``IGNORE_LABEL`` outside the loss."""
    a = cfg.audio
    if mel.shape[1] % a.chunk_frames:
        raise ValueError(f"mel has {mel.shape[1]} frames, not whole chunks of {a.chunk_frames}")
    num_chunks = mel.shape[1] // a.chunk_frames
    n_audio = num_chunks * a.tokens_per_chunk
    audio = encode_chunks_batch(a, params["encoder"], mel, [n_audio] * mel.shape[0], num_chunks, tp)
    # the reference rounds token embeddings to bf16 whatever the compute dtype
    tokens = dec.embed_tokens(params["decoder"], ids).to(torch.bfloat16)
    idx = torch.arange(ids.shape[1], device=ids.device)
    row = (idx - prefix_len).clamp(0, audio.shape[1] - 1)
    is_audio = (idx >= prefix_len) & (idx < prefix_len + n_audio)
    embeds = torch.where(is_audio[None, :, None], audio[:, row], tokens)

    hidden = dec.forward_train(cfg.decoder, params["decoder"], embeds, tp)
    logits = dec.logits_for(cfg.decoder, params["decoder"], hidden)
    mask = labels != IGNORE_LABEL
    ll = torch.log_softmax(logits.float(), dim=-1)
    token_ll = ll.gather(-1, torch.where(mask, labels, 0)[..., None])[..., 0]
    return -torch.where(mask, token_ll, 0.0).sum(), mask.sum()


def asr_loss(cfg: Qwen3ASRConfig, params: Dict[str, Any], mel: torch.Tensor, ids: torch.Tensor,
             labels: torch.Tensor, prefix_len: int) -> torch.Tensor:
    """The token-weighted mean negative log-likelihood of one device's batch."""
    total, count = loss_terms(cfg, params, mel, ids, labels, prefix_len)
    return total / count.clamp(min=1)


def _mesh_sizes(mesh) -> Tuple[int, int]:
    if mesh is None:
        return 1, 1
    return mesh[DATA_AXIS].size(), mesh[MODEL_AXIS].size()


def init_state(mesh, encoder_params: Dict[str, Any], decoder_params: Dict[str, Any],
               optimizer: OptimizerSpec, cfg: Qwen3ASRConfig, device="cuda") -> TrainState:
    """This rank's slice of dense parameter trees, copied to its device as
    leaves that require grad, and the optimizer over them. ``mesh`` None: one
    device, ``device``."""
    _dp, tp = _mesh_sizes(mesh)
    local_config(cfg, tp)  # raises unless tp divides every sharded width
    where = mesh_device(mesh, device)
    if tp > 1:
        encoder_params = shard_params(encoder_params, mesh)
        decoder_params = shard_params(decoder_params, mesh, cfg.decoder)

    def leaf(t: torch.Tensor) -> torch.Tensor:
        if not t.is_floating_point():
            raise ValueError(f"training takes dense parameter trees, not {t.dtype} leaves")
        return t.detach().to(where, copy=True).requires_grad_()

    params = {"encoder": tree_map(encoder_params, leaf), "decoder": tree_map(decoder_params, leaf)}
    return TrainState(params=params, optimizer=optimizer.build(tree_leaves(params)), step=0)


def make_train_step(cfg: Qwen3ASRConfig, mesh, prefix_len: int, device="cuda") -> Tuple[Callable, Callable]:
    """``(train_step, place_batch)``: ``train_step(state, mel, ids, labels)
    -> (state, loss)`` takes one optimizer step on the global batch and
    returns the global loss; ``place_batch(mel, ids, labels)`` gives this
    rank its ``dp`` slice of a host batch, on its device."""
    dp, tp = _mesh_sizes(mesh)
    local = local_config(cfg, tp)
    seams = TensorParallel(mesh) if tp > 1 else dec.Replicated
    dp_group = mesh.get_group(DATA_AXIS) if dp > 1 else None
    tp_group = mesh.get_group(MODEL_AXIS) if tp > 1 else None
    dp_rank = mesh.get_local_rank(DATA_AXIS) if mesh is not None else 0
    where = mesh_device(mesh, device)

    def train_step(state: TrainState, mel, ids, labels) -> Tuple[TrainState, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        with f32_matmuls():
            total, count = loss_terms(local, state.params, mel, ids, labels, prefix_len, seams)
            count = count.detach().clone()
            if dp_group is not None:
                dist.all_reduce(count, group=dp_group)
            loss = total / count.clamp(min=1)
            loss.backward()
        loss = loss.detach().clone()
        leaves = tree_leaves(state.params)
        for p in leaves:
            if p.grad is None:  # optax updates every leaf: a zero gradient still moves the moments
                p.grad = torch.zeros_like(p)
        if tp_group is not None:
            for p in head_local_leaves(state.params):
                dist.all_reduce(p.grad, group=tp_group)
        if dp_group is not None:
            for p in leaves:
                dist.all_reduce(p.grad, group=dp_group)
            dist.all_reduce(loss, group=dp_group)
        state.optimizer.step()
        state.step += 1
        return state, loss

    def place_batch(mel, ids, labels):
        mel, ids, labels = (torch.as_tensor(x) for x in (mel, ids, labels))
        if mel.shape[0] % dp:
            raise ValueError(f"batch of {mel.shape[0]} does not split over dp={dp}")
        rows = slice(dp_rank * (mel.shape[0] // dp), (dp_rank + 1) * (mel.shape[0] // dp))
        return (mel[rows].to(where, torch.float32), ids[rows].to(where, torch.int64),
                labels[rows].to(where, torch.int64))

    return train_step, place_batch

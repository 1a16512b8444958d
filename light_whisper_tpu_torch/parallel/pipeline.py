"""GPipe pipeline parallelism over a ``pp`` mesh dimension (counterpart of
``parallel/pipeline.py``).

The decoder's layers are stacked on a leading axis. Pipeline parallelism
cuts THAT axis: rank ``i`` of ``pp`` holds layers ``[i·L/pp, (i+1)·L/pp)``
and ``M`` microbatches stream through the stages in the GPipe schedule,
``M + pp − 1`` ticks: on tick ``t`` stage ``s`` runs microbatch ``t − s``
(when there is one) and hands its activations to stage ``s + 1``.

The reference runs the whole schedule as one ``lax.scan`` in a
``shard_map``, moves activations with ``lax.ppermute`` and gets the backward
pipeline from autodiff of it. Here each rank is a process, the hand-off is
``torch.distributed`` ``send``/``recv`` written out, and autograd goes
through the transfers: :class:`_Recv` and :class:`_Send` are functions whose
backward sends the gradient back the way the activation came. A stage's
sends are chained through a zero token, so its backward receives the
gradients in one order (the last microbatch first), the order the next stage
sends them in; the last stage broadcasts the outputs, so they are the same on
every rank (the reference's replicated ``psum``), and only its own copy
carries the gradient back.

On a ``(dp, pp)`` grid each dp row pipelines its own shard of a
``[M, B, T, D]`` batch; the outputs are gathered over ``dp`` and the layer
gradients summed over ``dp`` (:func:`make_train_step_pp`). The layer body is
:func:`decoder.make_train_layer`, the one body of training. No kernel runs
here: training is dense.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from light_whisper_tpu_torch.models.qwen3_asr import decoder as dec
from light_whisper_tpu_torch.models.qwen3_asr.config import DecoderConfig
from light_whisper_tpu_torch.parallel.mesh import DATA_AXIS, grid_mesh, mesh_device
from light_whisper_tpu_torch.parallel.train import (
    IGNORE_LABEL,
    OptimizerSpec,
    TrainState,
    f32_matmuls,
    tree_leaves,
    tree_map,
)

PIPE_AXIS = "pp"


def make_pp_mesh(pp: Optional[int] = None, dp: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A ``(dp, pp)`` mesh over the process group, rank ``r`` at ``(r // pp,
    r % pp)``: each dp row is one pipeline. ``pp`` defaults to the ranks left
    over from ``dp``. The default process group must be initialised on the
    backend of ``device_type`` (:func:`parallel.mesh.grid_mesh`)."""
    n = dist.get_world_size()
    pp = n // dp if pp is None else pp
    if dp * pp != n:
        raise ValueError(f"mesh dp{dp}xpp{pp} != {n} devices")
    return grid_mesh((dp, pp), (DATA_AXIS, PIPE_AXIS), device_type)


def _check_stages(block_count: int, pp: int) -> None:
    if block_count % pp != 0:
        raise ValueError(f"block_count={block_count} not divisible by pp={pp}")


def shard_layers_pp(layers: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's stage of stacked ``[L, ...]`` layer leaves: layers
    ``[i·L/pp, (i+1)·L/pp)`` for stage ``i``, copied to its device."""
    pp, stage = mesh[PIPE_AXIS].size(), mesh.get_local_rank(PIPE_AXIS)
    count = tree_leaves(layers)[0].shape[0]
    _check_stages(count, pp)
    n = count // pp
    device = mesh_device(mesh)
    return tree_map(layers, lambda leaf: leaf[stage * n:(stage + 1) * n].detach().to(device, copy=True))


def place_decoder_params_pp(params: Dict[str, Any], mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's stage of the layers and, whole, everything else (the
    embedding, the final norm and the head, which every stage holds)."""
    device = mesh_device(mesh)
    placed = {k: tree_map(v, lambda leaf: leaf.detach().to(device, copy=True))
              for k, v in params.items() if k != "layers"}
    placed["layers"] = shard_layers_pp(params["layers"], mesh)
    return placed


def _pipe_ranks(mesh: DeviceMesh) -> List[int]:
    """The global ranks of this rank's pipeline (its dp row), stage order."""
    return [int(r) for r in mesh.mesh[mesh.get_local_rank(DATA_AXIS)].tolist()]


class _Recv(torch.autograd.Function):
    """The activation from stage ``src``; backward sends its gradient back.
    ``anchor`` (a scalar that requires grad) puts the call on the graph."""

    @staticmethod
    def forward(ctx, anchor, src: int, shape, dtype):
        ctx.src = src
        x = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(x, src)
        return x

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), ctx.src)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Send ``y`` to stage ``dst``; returns a zero token chained after
    ``token``. Backward receives ``y``'s gradient from ``dst``."""

    @staticmethod
    def forward(ctx, y, token, dst: int):
        ctx.dst, ctx.shape, ctx.dtype = dst, y.shape, y.dtype
        dist.send(y.detach().contiguous(), dst)
        return token.detach().clone()

    @staticmethod
    def backward(ctx, grad_token):
        grad = torch.empty(ctx.shape, dtype=ctx.dtype, device=grad_token.device)
        dist.recv(grad, ctx.dst)
        return grad, grad_token, None


class _Broadcast(torch.autograd.Function):
    """The last stage's ``x`` on every stage of the pipeline; the gradient goes
    back only from the last stage's own copy (each stage computes the same
    loss from it)."""

    @staticmethod
    def forward(ctx, x, src: int, group, is_src: bool):
        ctx.is_src = is_src
        out = x.detach().contiguous().clone()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_src else None), None, None, None


class _GatherDp(torch.autograd.Function):
    """Every dp row's ``[M, B/dp, ...]`` outputs joined along the batch axis;
    the gradient of this row's slice goes back."""

    @staticmethod
    def forward(ctx, x, group, index: int, size: int):
        ctx.index, ctx.width = index, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad[:, ctx.index * ctx.width:(ctx.index + 1) * ctx.width], None, None, None


def pipeline_apply(
    mesh: DeviceMesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    layers: Dict[str, Any],
    microbatches: torch.Tensor,  # [M, ...] the first stage's inputs
) -> torch.Tensor:
    """Run ``microbatches`` through every stage's ``stage_fn(layers, x)`` (this
    rank's stage of the layers; activations keep a microbatch's shape and
    dtype) in the GPipe schedule. Returns the last stage's outputs ``[M,
    ...]`` on every stage of the pipeline."""
    pp, stage = mesh[PIPE_AXIS].size(), mesh.get_local_rank(PIPE_AXIS)
    ranks = _pipe_ranks(mesh)
    M = microbatches.shape[0]
    shape, dtype = microbatches.shape[1:], microbatches.dtype
    anchor = torch.zeros((), device=microbatches.device, requires_grad=torch.is_grad_enabled())
    token = torch.zeros((), device=microbatches.device)
    outs: List[torch.Tensor] = []
    for t in range(M + pp - 1):
        m = t - stage
        if not 0 <= m < M:
            continue  # a bubble tick of this stage
        x = microbatches[m] if stage == 0 else _Recv.apply(anchor, ranks[stage - 1], shape, dtype)
        y = stage_fn(layers, x)
        if stage < pp - 1:
            token = _Send.apply(y, token, ranks[stage + 1])
        else:
            outs.append(y)
    last = stage == pp - 1
    local = torch.stack(outs) if last else torch.zeros_like(microbatches)
    out = _Broadcast.apply(local, ranks[-1], mesh.get_group(PIPE_AXIS), last)
    if stage < pp - 1 and token.requires_grad:
        # the chain of sends rides the output into the loss (a zero): its
        # backward receives the next stage's gradients
        out = out + token
    return out


def forward_train_pp(cfg: DecoderConfig, params: Dict[str, Any], embeds_mb: torch.Tensor,
                     mesh: DeviceMesh) -> torch.Tensor:
    """Pipeline-parallel :func:`decoder.forward_train` over microbatches
    ``[M, T, D]`` (or ``[M, B, T, D]``): the same layer body on each stage's
    contiguous layers, then the final norm. On a mesh with ``dp > 1`` a 4-D
    input's ``B`` is split over the dp rows and the outputs gathered back.
    Needs ``block_count % pp == 0``. Returns the whole output on every rank."""
    pp = mesh[PIPE_AXIS].size()
    _check_stages(cfg.block_count, pp)
    dp = mesh[DATA_AXIS].size()
    split = embeds_mb.dim() == 4 and dp > 1
    x = embeds_mb.to(mesh_device(mesh))
    if split:
        if x.shape[1] % dp:
            raise ValueError(f"batch of {x.shape[1]} does not split over dp={dp}")
        width = x.shape[1] // dp
        index = mesh.get_local_rank(DATA_AXIS)
        x = x[:, index * width:(index + 1) * width]
    layer_fn = dec.make_train_layer(cfg, x.shape[-2], x.device)

    def run_stage(layers, h):
        for layer in dec.layer_views(layers):
            h = layer_fn(h, layer)
        return h

    hidden = pipeline_apply(mesh, run_stage, params["layers"], x)
    if split:
        hidden = _GatherDp.apply(hidden, mesh.get_group(DATA_AXIS), index, dp)
    return dec.rms_norm(hidden, params["final_norm"], cfg.rms_epsilon)


def pp_loss(cfg: DecoderConfig, params: Dict[str, Any], embeds_mb: torch.Tensor, labels_mb: torch.Tensor,
            mesh: DeviceMesh) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels that are not
    ``IGNORE_LABEL`` (the reference's ``make_train_step_pp`` loss)."""
    hidden = forward_train_pp(cfg, params, embeds_mb, mesh)
    logits = dec.logits_for(cfg, params, hidden)
    labels = labels_mb.to(logits.device).long()
    mask = labels != IGNORE_LABEL
    ll = torch.log_softmax(logits.float(), dim=-1)
    token_ll = ll.gather(-1, torch.where(mask, labels, 0)[..., None])[..., 0]
    return -torch.where(mask, token_ll, 0.0).sum() / mask.sum().clamp(min=1)


def init_state_pp(mesh: DeviceMesh, params: Dict[str, Any], optimizer: OptimizerSpec,
                  cfg: DecoderConfig) -> TrainState:
    """This rank's stage of a dense decoder tree as leaves that require grad,
    and the optimizer over them (each rank updates only what it holds)."""
    _check_stages(cfg.block_count, mesh[PIPE_AXIS].size())
    placed = tree_map(place_decoder_params_pp(params, mesh), lambda leaf: leaf.requires_grad_())
    return TrainState(params=placed, optimizer=optimizer.build(tree_leaves(placed)), step=0)


def backward_pp(cfg: DecoderConfig, params: Dict[str, Any], embeds_mb: torch.Tensor, labels_mb: torch.Tensor,
                mesh: DeviceMesh) -> torch.Tensor:
    """:func:`pp_loss` and its gradients in ``params``' leaves (every leaf gets
    one). On a ``(dp, pp)`` mesh with ``[M, B, T, D]`` inputs the layer
    gradients are summed over ``dp``; the head's and the norm's are whole on
    every rank already (every rank computes the loss of the whole batch).
    Returns the loss, detached."""
    with f32_matmuls():
        loss = pp_loss(cfg, params, embeds_mb, labels_mb, mesh)
        loss.backward()
    for p in tree_leaves(params):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh[DATA_AXIS].size() > 1 and embeds_mb.dim() == 4:
        for p in tree_leaves(params["layers"]):
            dist.all_reduce(p.grad, group=mesh.get_group(DATA_AXIS))
    return loss.detach()


def make_train_step_pp(cfg: DecoderConfig, mesh: DeviceMesh) -> Callable:
    """``step(state, embeds_mb, labels_mb) -> (state, loss)``: one optimizer
    step of :func:`pp_loss`, the gradients flowing back through the pipeline
    (:func:`backward_pp`)."""

    def step(state: TrainState, embeds_mb: torch.Tensor, labels_mb: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        loss = backward_pp(cfg, state.params, embeds_mb, labels_mb, mesh)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return step

"""Train-state checkpoints (counterpart of ``parallel/checkpoint.py``).

The reference commits an orbax directory atomically. Here each rank writes
its own slice (``shard-<rank>-of-<world>.pt``, ``torch.save`` of the
parameters, the optimizer's state and the step, flushed to disk) into
``<path>.tmp``, and rank 0 renames the directory to ``path`` once every rank
has written: a reader finds the whole checkpoint or the one before it. A
restore loads the rank's slice onto the template's devices and into its
tensors, so it lands on the template's shards.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Tuple

import torch
import torch.distributed as dist

from light_whisper_tpu_torch.parallel.train import TrainState, tree_leaves


def _rank_world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _shard_file(path: str, rank: int, world: int) -> str:
    return os.path.join(path, f"shard-{rank}-of-{world}.pt")


def save_train_state(path: str, state: TrainState) -> None:
    """Persist ``state`` (every rank its own slice) and commit it as ``path``."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    rank, world = _rank_world()
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier()
    payload = {"params": [p.detach() for p in tree_leaves(state.params)],
               "optimizer": state.optimizer.state_dict(), "step": state.step}
    with open(_shard_file(tmp, rank, world), "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    _barrier()
    if rank == 0:
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _barrier()


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """Load the checkpoint at ``path`` into ``template`` (same structure,
    shapes and dtypes, built by ``init_state`` on the same mesh) and return it."""
    rank, world = _rank_world()
    leaves = tree_leaves(template.params)
    saved = torch.load(_shard_file(os.path.abspath(path), rank, world), map_location=leaves[0].device,
                       weights_only=True)
    if len(saved["params"]) != len(leaves):
        raise ValueError(f"checkpoint holds {len(saved['params'])} parameters, the template {len(leaves)}")
    with torch.no_grad():
        for dst, src in zip(leaves, saved["params"]):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"checkpoint leaf {tuple(src.shape)} {src.dtype} != template "
                                 f"{tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
    template.optimizer.load_state_dict(saved["optimizer"])
    template.step = saved["step"]
    return template


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().cpu().reshape(-1)
    return t.view(torch.uint8) if t.is_floating_point() else t


def tree_equal(a: Any, b: Any) -> bool:
    """Bitwise equality of two states or trees (dicts, lists, tensors, numbers)."""
    if isinstance(a, TrainState) and isinstance(b, TrainState):
        return tree_equal((a.params, a.optimizer.state_dict(), a.step), (b.params, b.optimizer.state_dict(), b.step))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(tree_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))
    return type(a) is type(b) and a == b

"""Megatron tensor parallelism over the mesh's ``tp`` dimension (counterpart
of ``parallel/sharding.py``).

:func:`param_specs` is the reference's partition-spec tree, with tuples of
axis names in place of ``PartitionSpec``: attention q/k/v and FFN gate/up
shard their out-features over ``tp``, attention output and FFN down their
in-features, everything else is replicated.

GSPMD shards the fused ``qkv`` (``[D, (Hq+2·Hkv)·hd]``, q|k|v) and ``gateup``
(``[D, 2F]``, gate|up) by contiguous columns and inserts whatever collectives
that takes. A hand-written split cannot: contiguous columns would give rank 0
all the q heads, or all of gate. So :func:`shard_tree` cuts each part of a
fused projection apart (q, k and v by head group, gate and up by matching
column blocks) and every rank computes whole heads of its own. The row-parallel
o and down (and the encoder's o and fc2) then need one all-reduce each:
:class:`TensorParallel`'s ``reduce``, with ``enter`` as its adjoint at the
head of each column-parallel block. The per-head q and k norms are
replicated but see only a rank's heads, so their gradients are summed over
``tp`` after the backward (:func:`head_local_leaves`).

Serving (``Qwen3ASRModel(mesh=)``) shards the loader's trees, Q8_0 ones
included, with the same cut. :func:`param_specs` keeps the reference's rule
word for word, which names a Q8 leaf ``o/q`` by its key ``q`` and so gives it
q's out-feature spec: GSPMD computes the same function whatever the layout,
but written-out collectives need each leaf cut along the axis its linear
contracts or emits. So :func:`shard_tree` reads a leaf's spec from the linear
that holds it (:func:`_layout_spec`). The serving widths are
:func:`serving_config`'s, which checks what the reference's model checks (the
KV heads) and keeps an encoder whose heads ``tp`` does not divide replicated;
:func:`shard_cache` is the reference's ``place_cache`` layout,
``[L, Hkv/tp, C, hd]``.

Orientation (``ops.linear``): dense ``w`` is ``[in, out]``, Q8_0 ``q`` is
``[out, in]`` with scales ``[out, in/32]``; stacked layer leaves carry a
leading layer axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from light_whisper_tpu_torch.models.qwen3_asr.config import DecoderConfig, Qwen3ASRConfig
from light_whisper_tpu_torch.parallel.mesh import MODEL_AXIS

_OUT_SHARDED = {"q", "k", "v", "qkv", "gate", "up", "gateup", "fc1"}
_IN_SHARDED = {"o", "down", "fc2"}
_LINEAR_KEYS = ("w", "q", "s", "b")
Q8_BLOCK = 32  # in-features a Q8_0 scale covers


def _spec_for_linear(name: str, key: str, stacked: bool) -> Tuple:
    lead = (None,) if stacked else ()
    if name in _OUT_SHARDED:
        if key == "w":  # [in, out]
            return (*lead, None, MODEL_AXIS)
        if key in ("q", "s"):  # [out, in(/32)]
            return (*lead, MODEL_AXIS, None)
        if key == "b":  # [out]
            return (*lead, MODEL_AXIS)
    if name in _IN_SHARDED:
        if key == "w":
            return (*lead, MODEL_AXIS, None)
        if key in ("q", "s"):
            return (*lead, None, MODEL_AXIS)
        if key == "b":
            return (*lead, None)
    return ()


def _spec(names: Sequence[str]) -> Tuple:
    """The reference's spec of the leaf at ``names``: that of the nearest
    name of a linear (for a Q8 leaf ``qkv/q`` that is the key ``q``: the same
    spec as ``qkv``'s; for ``o/q`` too, see :func:`_layout_spec`)."""
    stacked = "layers" in names
    for name in reversed(names):
        if name in _OUT_SHARDED or name in _IN_SHARDED:
            return _spec_for_linear(name, names[-1], stacked)
    return ()


def _layout_spec(names: Sequence[str]) -> Tuple[Tuple, Optional[str]]:
    """(spec, linear) of the leaf at ``names`` by the linear that holds it:
    ``o/q`` is cut along o's in-features, ``embed/q`` not at all. The same
    as :func:`_spec` on every dense tree."""
    if len(names) >= 2 and names[-1] in _LINEAR_KEYS and names[-2] in _OUT_SHARDED | _IN_SHARDED:
        return _spec_for_linear(names[-2], names[-1], "layers" in names), names[-2]
    return (), None


def _walk(tree, fn, names=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, names + (k,)) for k, v in tree.items()}
    return fn(names, tree)


def param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree of a decoder or encoder parameter tree: per leaf, a tuple
    with ``"tp"`` on the sharded dimension (``()`` when replicated)."""
    return _walk(params, lambda names, _leaf: _spec(names))


def local_config(cfg: Qwen3ASRConfig, tp: int) -> Qwen3ASRConfig:
    """The widths one of ``tp`` ranks computes: its share of the heads and
    of the FFN columns. ``tp`` must divide each of them (the KV heads first,
    as the reference's ``Qwen3ASRModel(mesh=)`` checks)."""
    d, a = cfg.decoder, cfg.audio
    if d.head_count_kv % tp:
        raise ValueError(f"tp={tp} must divide kv heads {d.head_count_kv}")
    for what, n in (("decoder heads", d.head_count), ("decoder FFN width", d.feed_forward_length),
                    ("encoder heads", a.head_count), ("encoder FFN width", a.feed_forward_length)):
        if n % tp:
            raise ValueError(f"tp={tp} must divide the {what} ({n})")
    return dataclasses.replace(
        cfg,
        decoder=dataclasses.replace(d, head_count=d.head_count // tp, head_count_kv=d.head_count_kv // tp,
                                    feed_forward_length=d.feed_forward_length // tp),
        audio=dataclasses.replace(a, head_count=a.head_count // tp,
                                  feed_forward_length=a.feed_forward_length // tp),
    )


def serving_config(cfg: Qwen3ASRConfig, tp: int) -> Tuple[Qwen3ASRConfig, bool]:
    """``(the widths one of tp serving ranks computes, whether the encoder is
    sharded)``. The decoder is always sharded: ``tp`` must divide its KV heads
    (the reference's ``Qwen3ASRModel(mesh=)`` check, with its message), and so
    its query heads, and its FFN width. The encoder is sharded only where
    ``tp`` divides its heads and FFN width; elsewhere every rank keeps it
    whole, which computes the same function (the reference's GSPMD splits
    its columns through a head there: 14 heads of the 0.6B and 1.7B encoders
    over tp=4)."""
    d, a = cfg.decoder, cfg.audio
    if d.head_count_kv % tp:
        raise ValueError(f"tp={tp} must divide kv heads {d.head_count_kv}")
    if d.feed_forward_length % tp:
        raise ValueError(f"tp={tp} must divide the decoder FFN width ({d.feed_forward_length})")
    decoder = dataclasses.replace(d, head_count=d.head_count // tp, head_count_kv=d.head_count_kv // tp,
                                  feed_forward_length=d.feed_forward_length // tp)
    encoder_sharded = a.head_count % tp == 0 and a.feed_forward_length % tp == 0
    audio = a if not encoder_sharded else dataclasses.replace(
        a, head_count=a.head_count // tp, feed_forward_length=a.feed_forward_length // tp)
    return dataclasses.replace(cfg, decoder=decoder, audio=audio), encoder_sharded


def shard_cache(cache, index: int, count: int):
    """Rank ``index`` of ``count``'s block of the KV heads of a cache: a
    ``KVCache`` ``[L, Hkv, C, hd]`` or a ``BatchKVCache`` ``[B, L, Hkv, C,
    hd]`` (the reference's ``P(None, "tp", None, None)``). Positions are
    kept."""
    if count == 1:
        return cache
    dim = cache.k.dim() - 3
    heads = cache.k.shape[dim]
    if heads % count:
        raise ValueError(f"a cache of {heads} KV heads does not split over tp={count}")
    n = heads // count
    return dataclasses.replace(cache, k=cache.k.narrow(dim, index * n, n).contiguous(),
                               v=cache.v.narrow(dim, index * n, n).contiguous())


def _blocks(name: str, size: int, dim_is_out: bool, cfg: Optional[DecoderConfig]) -> List[int]:
    """The parts of a sharded dimension that are split apart: q|k|v of the
    fused qkv's out-features, gate|up of gateup's, else the whole dimension."""
    if not dim_is_out:
        return [size]
    if name == "qkv":
        if cfg is None:
            raise ValueError("sharding a fused qkv needs the decoder config (its head counts)")
        q, kv = cfg.head_count * cfg.key_length, cfg.head_count_kv * cfg.key_length
        if size != q + 2 * kv:
            raise ValueError(f"qkv width {size} != (Hq + 2·Hkv)·hd = {q + 2 * kv}")
        return [q, kv, kv]
    if name == "gateup":
        return [size // 2, size // 2]
    return [size]


def _leaf_layout(names, leaf, cfg, count: int = 1):
    """(sharded dimension, its parts' whole widths) of a leaf, or None when
    replicated; ``count``: the number of slices ``leaf`` is one of."""
    spec, name = _layout_spec(names)
    if MODEL_AXIS not in spec:
        return None
    dim = spec.index(MODEL_AXIS)
    return dim, _blocks(name, leaf.shape[dim] * count, name in _OUT_SHARDED, cfg)


def shard_tree(params: Dict[str, Any], index: int, count: int, cfg: Optional[DecoderConfig] = None):
    """Rank ``index`` of ``count``'s slice of a parameter tree: each part of a
    sharded dimension cut in ``count`` contiguous pieces, piece ``index`` of
    every part kept (whole heads, matching gate and up columns). Replicated
    leaves are returned as they are. ``cfg``: the decoder's, for ``qkv``."""

    def cut(names, leaf):
        layout = _leaf_layout(names, leaf, cfg)
        if layout is None or count == 1:
            return leaf
        dim, blocks = layout
        if names[-1] in ("q", "s") and dim == leaf.dim() - 1:
            # a Q8_0 linear cut along its in-features: each rank's slice holds whole 32-wide blocks
            blocks_in = leaf.shape[dim] // (Q8_BLOCK if names[-1] == "q" else 1)
            if blocks_in % count:
                raise ValueError(f"{'/'.join(names)}: {blocks_in} Q8_0 blocks of 32 in-features do not split "
                                 f"over tp={count}: in/tp must be a multiple of 32")
        pieces, start = [], 0
        for size in blocks:
            if size % count:
                raise ValueError(f"{'/'.join(names)}: a part of {size} does not split over tp={count}")
            pieces.append(leaf.narrow(dim, start + index * (size // count), size // count))
            start += size
        return torch.cat(pieces, dim=dim).contiguous()

    return _walk(params, cut)


def merge_shards(trees: Sequence[Dict[str, Any]], cfg: Optional[DecoderConfig] = None):
    """The inverse of :func:`shard_tree`: the whole tree from every rank's
    slice, in rank order (replicated leaves from rank 0)."""
    count = len(trees)

    def join(names, leaf0):
        layout = _leaf_layout(names, leaf0, cfg, count)
        if layout is None or count == 1:
            return leaf0
        dim, blocks = layout
        widths = [size // count for size in blocks]
        parts = [torch.split(_get(t, names), widths, dim=dim) for t in trees]
        return torch.cat([parts[r][j] for j in range(len(widths)) for r in range(count)], dim=dim)

    return _walk(trees[0], join)


def _get(tree, names):
    for n in names:
        tree = tree[n]
    return tree


# replicated leaves that act on one rank's heads only: their gradients are
# partial on each rank and summed over tp
_HEAD_LOCAL = ("q_norm", "k_norm")


def head_local_leaves(params: Dict[str, Any]) -> List[Any]:
    """The leaves of ``params`` replicated over ``tp`` but applied to this
    rank's heads alone (the decoder's per-head q and k norms)."""
    found = []
    _walk(params, lambda names, leaf: found.append(leaf) if names[-1] in _HEAD_LOCAL else None)
    return found


def shard_params(params: Dict[str, Any], mesh, cfg: Optional[DecoderConfig] = None):
    """This rank's slice of ``params`` on ``mesh`` (its ``tp`` coordinate)."""
    return shard_tree(params, mesh.get_local_rank(MODEL_AXIS), mesh[MODEL_AXIS].size(), cfg)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """Sum over the group forward; the gradient passed through (Megatron's g).
    ``torch.distributed.nn.functional.all_reduce`` sums the gradient as well,
    which counts a loss that every rank computes once per rank."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorParallel:
    """The seams of a tensor-parallel layer over the mesh's ``tp`` group
    (``decoder.Replicated`` is the one-device counterpart): ``enter`` at the
    input of each column-parallel block, ``reduce`` on each row-parallel
    block's f32 partial output."""

    def __init__(self, mesh):
        self.group = mesh.get_group(MODEL_AXIS)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

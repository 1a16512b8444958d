"""Sequence-parallel long-form encoding over an ``sp`` mesh dimension
(counterpart of ``parallel/encoder_sp.py``).

The AuT encoder's attention is block-diagonal over window groups of
``chunks_per_group`` chunks (``n_window_infer // chunk_frames``, 4 on the
real configs; ``models/qwen3_asr/encoder.py``): no group attends across its
boundary, the convolutions never see across a chunk and positions restart at
each chunk. So each ``sp`` rank encodes a contiguous run of whole window
groups on its own and one all-gather puts the token rows back in order; the
result is replicated, as the reference's ``out_shardings``.

The reference shards the mel frames evenly over ``sp`` and lets GSPMD insert
whatever a group that spans two devices needs. A hand-written split cannot
cut a group, so the cut falls on group boundaries: ranks may hold unequal
numbers of groups, some none. The reference's check that ``sp`` divides the
chunk count is kept.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from light_whisper_tpu_torch.models.qwen3_asr.config import AudioEncoderConfig
from light_whisper_tpu_torch.models.qwen3_asr.decoder import torch_dtype
from light_whisper_tpu_torch.models.qwen3_asr.encoder import encode_chunks
from light_whisper_tpu_torch.parallel.mesh import DATA_AXIS, grid_mesh, mesh_device

SEQUENCE_AXIS = "sp"


def make_sp_mesh(sp: Optional[int] = None, device_type: str = "cuda") -> DeviceMesh:
    """A ``(dp, sp)`` mesh over the process group (initialised on the
    backend of ``device_type``): ``sp`` ranks a row (default all of them),
    each row encoding the same input."""
    n = dist.get_world_size()
    sp = n if sp is None else sp
    if n % sp:
        raise ValueError(f"sp={sp} does not divide {n} ranks")
    return grid_mesh((n // sp, sp), (DATA_AXIS, SEQUENCE_AXIS), device_type)


def replicate_params(params: Dict, mesh: DeviceMesh) -> Dict:
    """The encoder's (small) parameter tree, whole, on this rank's device."""
    device = mesh_device(mesh)
    if isinstance(params, dict):
        return {k: replicate_params(v, mesh) for k, v in params.items()}
    return params.to(device)


def group_bounds(num_chunks: int, chunks_per_group: int, sp: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of the chunks each of ``sp`` ranks encodes: rank r takes
    window groups ``[r·G/sp, (r+1)·G/sp)`` of the ``G`` groups, whole."""
    groups = -(-num_chunks // chunks_per_group)
    cut = [min(r * groups // sp * chunks_per_group, num_chunks) for r in range(sp + 1)]
    return list(zip(cut[:-1], cut[1:]))


def encode_chunks_sp(
    cfg: AudioEncoderConfig,
    params: Dict,
    mel: torch.Tensor,  # [num_chunks * chunk_frames, mels], the same on every rank
    valid_tokens: int,
    num_chunks: int,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """:func:`encode_chunks` over the mesh's ``sp`` ranks:
    ``[num_chunks * tokens_per_chunk, output_dim]`` on every rank."""
    sp = mesh[SEQUENCE_AXIS].size()
    if num_chunks % sp != 0:
        raise ValueError(f"num_chunks={num_chunks} not divisible by sp={sp}")
    device = mesh_device(mesh)
    tpc = cfg.tokens_per_chunk
    chunks_per_group = max(1, cfg.window_tokens // tpc)
    bounds = group_bounds(num_chunks, chunks_per_group, sp)
    lo, hi = bounds[mesh.get_local_rank(SEQUENCE_AXIS)]
    width = max(b - a for a, b in bounds) * tpc
    rows = torch.zeros((width, cfg.output_dim), dtype=torch.float32, device=device)
    if hi > lo:
        frames = mel[lo * cfg.chunk_frames: hi * cfg.chunk_frames].to(device)
        # the mask counts from the run's first token: a group wholly past the
        # valid tokens is masked whole, as in the one-device call
        out = encode_chunks(cfg, params, frames, max(0, valid_tokens - lo * tpc), hi - lo)
        rows[: out.shape[0]] = out.float()  # the compute dtype's values, exact in f32
    parts = [torch.empty_like(rows) for _ in range(sp)]
    dist.all_gather(parts, rows, group=mesh.get_group(SEQUENCE_AXIS))
    out = torch.cat([part[: (b - a) * tpc] for part, (a, b) in zip(parts, bounds)])
    return out.to(torch_dtype(cfg.compute_dtype))

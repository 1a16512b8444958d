"""Process group and (dp, tp) device mesh (counterpart of ``parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives; here every rank is one process on one device, the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dimensions named ``dp`` and
``tp``, and the collectives are written out (``sharding``, ``train``).

The backend follows the device: NCCL on ``cuda``, gloo only when the caller
asks for the CPU. Nothing on the card falls back to gloo.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from light_whisper_tpu_torch.models.qwen3_asr.model import resolve_device

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device_type: str) -> str:
    """The collective backend of ``device_type``: NCCL for ``cuda`` (which
    needs a card), gloo for ``cpu``."""
    if device_type not in BACKENDS:
        raise ValueError(f"no collective backend for device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is false")
    return BACKENDS[device_type]


def init_distributed(device_type: str, rank: int, world_size: int, *, store: Optional[dist.Store] = None,
                     init_method: Optional[str] = None, timeout_s: float = 300.0) -> None:
    """Join the default process group as ``rank`` of ``world_size``, over
    ``store`` (a ``FileStore`` in tests) or ``init_method`` (for instance
    ``tcp://localhost:<port>``). On ``cuda`` the rank takes card
    ``rank % device_count``."""
    backend = backend_for(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def mesh_shape(dp: Optional[int], tp: Optional[int], n: int) -> Tuple[int, int]:
    """The reference's sizing rule: with one size given, the other takes the
    remaining devices; with neither, every device goes to ``tp``. A product
    other than ``n`` is a ``ValueError``."""
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    return dp, tp


def grid_mesh(shape: Tuple[int, int], names: Tuple[str, str], device_type: str = "cuda") -> DeviceMesh:
    """A 2-D mesh of ``shape`` over the process group's ranks in row-major
    order, its dimensions named ``names``. The default process group must be
    initialised (:func:`init_distributed`) on the backend of ``device_type``,
    and hold ``shape``'s ranks."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group: call init_distributed first")
    expected = backend_for(device_type)
    if dist.get_backend() != expected:
        raise ValueError(f"a {device_type} mesh needs the {expected} backend, not {dist.get_backend()}")
    grid = torch.arange(shape[0] * shape[1]).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None, devices: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A (dp, tp) mesh over ``devices`` ranks (default: the process group's
    world size), rank ``r`` at ``(r // tp, r % tp)``: the tp ranks of a data
    shard are neighbours, as in the reference's row-major grid
    (:func:`grid_mesh`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call init_distributed first")
    n = dist.get_world_size() if devices is None else devices
    return grid_mesh(mesh_shape(dp, tp, n), (DATA_AXIS, MODEL_AXIS), device_type)


def mesh_device(mesh: Optional[DeviceMesh], device="cuda") -> torch.device:
    """The device this rank computes on: its card under a ``cuda`` mesh, the
    CPU under a ``cpu`` one, ``device`` without a mesh."""
    if mesh is None:
        return resolve_device(device)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)

"""Parameter trees from the JAX package's trees taken to numpy.

``params_from_numpy(encoder_params, decoder_params, device)`` turns the
reference's parameter trees, given as numpy arrays (for instance
``jax.tree.map(np.asarray, tree)``), into this port's trees of tensors, so
both packages compute from the same bits. bf16 leaves (numpy's extension
dtype named ``bfloat16``) are reinterpreted bit for bit; the TPU-only
pre-transposed scales (``s_t``) are dropped.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_DROP = ("s_t",)


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # arrays taken from JAX are read-only views
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tree_from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items() if k not in _DROP}
    return tensor_from_numpy(tree, device)


def params_from_numpy(encoder_params: Dict, decoder_params: Dict, device="cpu") -> Tuple[Dict, Dict]:
    """(encoder tree, decoder tree) of tensors on ``device``."""
    return tree_from_numpy(encoder_params, device), tree_from_numpy(decoder_params, device)

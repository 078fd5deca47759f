"""Carry parameter (and cache) trees between the JAX package and the
port — the counterparts of ``fl/cnn.py``'s ``params_from_jax`` /
``params_to_jax`` for the decoders.

Both packages use the same nested-dict tree with the same keys and
layouts (``wq`` [d, H, Dh], stacked layers on a leading axis, ...), so a
conversion is a tree map.  The JAX side is handed over as numpy arrays
(``jax.tree_util.tree_map(np.asarray, tree)``); a bfloat16 leaf
(``ml_dtypes``' type) crosses through float32, which is exact both ways.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

from .layers import tree_map

def _to_torch(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bfloat16 of its own
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_jax(np_tree: dict, device=None) -> dict:
    """A JAX parameter or cache tree (numpy leaves) -> the port's tree
    of tensors on ``device`` (the card unless the caller asks for the
    CPU), leaf dtypes kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_torch(a, dev), np_tree)


def params_to_jax(tree: dict) -> dict:
    """Inverse of :func:`params_from_jax`: numpy leaves ready for
    ``jnp.asarray`` (bfloat16 leaves come back as float32)."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(one, tree)

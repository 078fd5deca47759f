"""SGD with optional momentum (the port of ``repro.optim.sgd``)."""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from .base import Optimizer


def sgd(lr: float = 0.01, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return None
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def update(grads, state, params=None):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g.to(torch.float32),
                            grads), None
        new_state = tree_map(
            lambda m, g: momentum * m + g.to(torch.float32), state, grads)
        updates = tree_map(lambda m: -lr * m, new_state)
        return updates, new_state

    return Optimizer(init=init, update=update)

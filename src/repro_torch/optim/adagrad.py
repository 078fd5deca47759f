"""AdaGrad — the paper's local optimizer (eq. 2).

    g_acc <- g_acc + grad * grad
    w     <- w - alpha / sqrt(g_acc + eps) * grad

Op for op ``repro.optim.adagrad``: ``-alpha * g`` first, then the IEEE
division by ``sqrt(a + eps)``.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from .base import Optimizer


def adagrad(alpha: float = 0.01, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    def update(grads, state, params=None):
        new_state = tree_map(
            lambda a, g: a + torch.square(g.to(torch.float32)), state, grads)
        updates = tree_map(
            lambda g, a: -alpha * g.to(torch.float32) / torch.sqrt(a + eps),
            grads, new_state)
        return updates, new_state

    return Optimizer(init=init, update=update)

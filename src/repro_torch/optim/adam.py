"""Adam (bias-corrected), fp32 moments (the port of
``repro.optim.adam``).

The step count is an int32 tensor, and the bias corrections
``1 - b ** c`` are computed in f32 from it, as jnp computes them: one
rounded f32 ``pow``, as jitted XLA does (eager jnp takes repeated
products instead, up to an ulp of ``b ** c`` apart)."""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves, tree_map

from .base import Optimizer


def adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
        device = tree_leaves(params)[0].device
        return {"mu": z, "nu": tree_map(torch.clone, z),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params=None):
        c = state["count"] + 1
        mu = tree_map(
            lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
            state["mu"], grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2)
            * torch.square(g.to(torch.float32)), state["nu"], grads)
        cf = c.to(torch.float32)
        corr1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=cf.device), cf)
        corr2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=cf.device), cf)
        mu_hat = tree_map(lambda m: m / corr1, mu)
        nu_hat = tree_map(lambda v: v / corr2, nu)
        updates = tree_map(
            lambda m, v: -lr * m / (torch.sqrt(v) + eps), mu_hat, nu_hat)
        if weight_decay and params is not None:
            updates = tree_map(
                lambda u, p: u - lr * weight_decay * p.to(torch.float32),
                updates, params)
        return updates, {"mu": mu, "nu": nu, "count": c}

    return Optimizer(init=init, update=update)

"""Minimal optimizer interface on dicts of tensors (the port of
``repro.optim.base``)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

from torch.utils._pytree import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]                    # params -> state
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    # (grads, state, params) -> (updates, new_state); caller applies
    # params + updates.


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)

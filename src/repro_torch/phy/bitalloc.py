"""Batched rate-aware bit allocation (``core.power.bitalloc``'s closed
forms over any leading axes), so a whole sweep grid's per-user
high-resolution budgets come out of one device call.  The numpy
originals stay the reference."""
from __future__ import annotations

import torch


def rate_aware_fractions_batch(rates: torch.Tensor, d: int, b: int,
                               target_latency_s,
                               s_min: float = 0.0, s_max: float = 1.0
                               ) -> torch.Tensor:
    """s_j = clip((ell* R_j - 32 - d) / (d (b - 1)), s_min, s_max);
    ``target_latency_s`` may be a scalar or [..., 1] for per-cell
    targets."""
    rates = torch.as_tensor(rates)
    s = (target_latency_s * rates - 32.0 - d) / (d * (b - 1.0))
    return torch.clamp(s, s_min, s_max)


def equalizing_target_latency_batch(rates: torch.Tensor, d: int, b: int,
                                    s_floor: float) -> torch.Tensor:
    """Smallest round latency at which every user of each cell can
    afford s >= s_floor; reduces the trailing user axis."""
    bits_floor = d * (b * s_floor + 1.0 - s_floor) + 32.0
    return torch.amax(bits_floor / torch.as_tensor(rates), dim=-1)


__all__ = ["equalizing_target_latency_batch", "rate_aware_fractions_batch"]

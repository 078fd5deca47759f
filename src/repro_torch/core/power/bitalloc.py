"""Beyond-paper: rate-aware per-user bit allocation.

The paper fixes (lambda_j, b_j) per user and adapts powers to the
resulting bits.  The datacenter analogue (and the paper's own "future
work" direction) is the converse: given heterogeneous link rates, give
weak links a smaller high-resolution budget so every participant
finishes the round together.

Given target round latency ell*, rates R_j and the wire-format model
``bits_j(s) = d (b s + 1 - s) + 32``, solve for the per-user
high-resolution fraction:

    s_j = clip( (ell* R_j - 32 - d) / (d (b - 1)), s_min, s_max ).

A copy of ``repro.core.power.bitalloc``: the same rates give the same
arrays.
"""
from __future__ import annotations

import numpy as np


def rate_aware_fractions(rates: np.ndarray, d: int, b: int,
                         target_latency_s: float,
                         s_min: float = 0.0, s_max: float = 1.0
                         ) -> np.ndarray:
    rates = np.asarray(rates, np.float64)
    s = (target_latency_s * rates - 32.0 - d) / (d * (b - 1.0))
    return np.clip(s, s_min, s_max)


def equalizing_target_latency(rates: np.ndarray, d: int, b: int,
                              s_floor: float) -> float:
    """Smallest round latency at which every user can afford s >= s_floor."""
    bits_floor = d * (b * s_floor + 1.0 - s_floor) + 32.0
    return float(np.max(bits_floor / np.asarray(rates, np.float64)))

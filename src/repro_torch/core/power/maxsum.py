"""Max-sum-rate power control benchmark [2].

maximize  sum_j log2(1 + SINR_j(p))  s.t.  0 <= p <= 1.

Non-convex; we use projected gradient ascent from full power with a
few random restarts — the standard practical approach.  Max-sum-rate
ignores per-user payloads entirely, which is exactly why it suffers
from stragglers in the paper's Table III.  Host numpy, a copy of
``repro.core.power.maxsum``: the same channel gives the same arrays.
"""
from __future__ import annotations

import numpy as np

from ..channel.cfmmimo import ChannelRealization
from .base import PowerController, PowerSolution


def _sum_rate(chan: ChannelRealization, p: np.ndarray) -> float:
    return float(np.sum(np.log2(1.0 + chan.sinr(p))))


def _grad(chan: ChannelRealization, p: np.ndarray, h: float = 1e-6
          ) -> np.ndarray:
    g = np.zeros_like(p)
    base = _sum_rate(chan, p)
    for j in range(p.size):
        q = p.copy()
        q[j] = min(1.0, q[j] + h)
        g[j] = (_sum_rate(chan, q) - base) / max(q[j] - p[j], 1e-12)
    return g


class MaxSumRatePowerControl(PowerController):
    name = "max-sum-rate"

    def __init__(self, iters: int = 80, lr: float = 0.1, restarts: int = 2):
        self.iters, self.lr, self.restarts = iters, lr, restarts

    def solve(self, chan: ChannelRealization, bits: np.ndarray
              ) -> PowerSolution:
        rng = np.random.default_rng(0)
        starts = [np.ones(chan.cfg.K)]
        starts += [rng.uniform(0.3, 1.0, chan.cfg.K)
                   for _ in range(self.restarts)]
        best_p, best_v = starts[0], -np.inf
        for p in starts:
            p = p.copy()
            for _ in range(self.iters):
                p = np.clip(p + self.lr * _grad(chan, p), 0.0, 1.0)
            v = _sum_rate(chan, p)
            if v > best_v:
                best_p, best_v = p, v
        return self._finish(chan, bits, best_p, sum_rate=best_v)

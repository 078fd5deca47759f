"""Dinkelbach power control benchmark [21] — energy-efficiency maximizer.

maximize  EE(p) = sum_j R_j(p) / (P_c + p^u sum_j p_j)   s.t. 0<=p<=1.

Classic fractional programming: Dinkelbach's iteration solves
``max_p  N(p) - lam * D(p)`` and updates ``lam = N(p*)/D(p*)`` until the
auxiliary objective vanishes.  The inner (non-convex) subproblem is
handled by projected gradient ascent — adequate at K <= 40.  Host
numpy, a copy of ``repro.core.power.dinkelbach``: the same channel and
bits give the same arrays.
"""
from __future__ import annotations

import numpy as np

from ..channel.cfmmimo import ChannelRealization
from .base import PowerController, PowerSolution


class DinkelbachPowerControl(PowerController):
    name = "dinkelbach"

    def __init__(self, p_circuit_w: float = 0.2, outer: int = 12,
                 inner: int = 60, lr: float = 0.1, tol: float = 1e-6):
        self.p_circuit_w = float(p_circuit_w)
        self.outer, self.inner, self.lr, self.tol = outer, inner, lr, tol

    def _numer(self, chan: ChannelRealization, p: np.ndarray) -> float:
        return float(np.sum(np.log2(1.0 + chan.sinr(p))))

    def _denom(self, chan: ChannelRealization, p: np.ndarray) -> float:
        return self.p_circuit_w + chan.cfg.p_max_w * float(np.sum(p))

    def solve(self, chan: ChannelRealization, bits: np.ndarray
              ) -> PowerSolution:
        K = chan.cfg.K
        p = np.ones(K)
        lam = self._numer(chan, p) / self._denom(chan, p)
        outer_used = 0
        for _ in range(self.outer):
            outer_used += 1
            # inner: max_p numer(p) - lam * denom(p) by projected ascent
            for _ in range(self.inner):
                g = np.zeros(K)
                base = self._numer(chan, p) - lam * self._denom(chan, p)
                h = 1e-6
                for j in range(K):
                    q = p.copy()
                    q[j] = min(1.0, q[j] + h)
                    val = self._numer(chan, q) - lam * self._denom(chan, q)
                    g[j] = (val - base) / max(q[j] - p[j], 1e-12)
                p = np.clip(p + self.lr * g, 0.0, 1.0)
            f = self._numer(chan, p) - lam * self._denom(chan, p)
            lam_new = self._numer(chan, p) / self._denom(chan, p)
            if abs(f) < self.tol:
                lam = lam_new
                break
            lam = lam_new
        return self._finish(chan, bits, p, energy_efficiency=lam,
                            dinkelbach_iters=outer_used)

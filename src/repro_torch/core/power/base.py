"""Power-control interface.

A power controller maps (channel realization, per-user payload bits) to
an uplink power vector ``p in [0,1]^K``.  The paper's objective (eq. 11)
is to minimize the straggler latency ``max_j b_j / R_j(p)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..channel.cfmmimo import ChannelRealization, uplink_latency


@dataclasses.dataclass(frozen=True)
class PowerSolution:
    p: np.ndarray              # [K] power-control coefficients in [0,1]
    rates: np.ndarray          # [K] achieved rates (bit/s)
    latencies: np.ndarray      # [K] per-user uplink latency (s)
    info: Dict[str, float]     # solver diagnostics

    @property
    def straggler_latency(self) -> float:
        return float(np.max(self.latencies))


class PowerController:
    name = "base"

    def solve(self, chan: ChannelRealization, bits: np.ndarray
              ) -> PowerSolution:
        raise NotImplementedError

    def _finish(self, chan: ChannelRealization, bits: np.ndarray,
                p: np.ndarray, **info) -> PowerSolution:
        p = np.clip(np.asarray(p, np.float64), 0.0, 1.0)
        rates = chan.rates(p)
        return PowerSolution(p=p, rates=rates,
                             latencies=uplink_latency(bits, rates),
                             info=dict(info))

"""Round-log aggregation — the numbers the benchmark tables consume.

``summarize_logs`` is ``repro.sim.metrics.summarize_logs``: it reduces
a list of per-round :class:`RoundLog` records to the scalar metrics of
the paper's tables (best/final accuracy, rounds completed, mean payload
bits, mean high-resolution fraction, cumulative latency, straggler
percentiles) plus the straggler-gap and async columns, which stay at
their sync defaults on the port's lockstep path.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def summarize_logs(logs: List) -> Dict[str, float]:
    """Aggregate a FLResult.logs list into one metrics row."""
    accs = [l.test_acc for l in logs if l.test_acc is not None]
    uplinks = np.array([l.uplink_latency_s for l in logs])
    bits = np.array([np.mean(l.bits_per_user) for l in logs])
    return {
        "rounds": float(logs[-1].round) if logs else 0.0,
        "best_acc": float(max(accs)) if accs else float("nan"),
        "final_acc": float(accs[-1]) if accs else float("nan"),
        "mean_bits_per_user": float(bits.mean()) if logs else float("nan"),
        "mean_s": float(np.mean([l.mean_s for l in logs]))
        if logs else float("nan"),
        "total_latency_s": float(logs[-1].cum_latency_s)
        if logs else 0.0,
        "mean_uplink_s": float(uplinks.mean()) if logs else 0.0,
        "p95_uplink_s": float(np.percentile(uplinks, 95))
        if logs else 0.0,
        "mean_straggler_gap_s": float(np.mean(
            [l.straggler_gap_s for l in logs])) if logs else 0.0,
        "mean_staleness": float(np.mean(
            [l.mean_staleness for l in logs])) if logs else 0.0,
        "effective_participation": float(np.mean(
            [l.effective_participation for l in logs]))
        if logs else float("nan"),
        "dropped_uploads": float(sum(l.dropped_uploads for l in logs)),
        "quarantined_users": float(sum(l.quarantined_users for l in logs)),
        "power_fallbacks": float(sum(l.power_fallbacks for l in logs)),
    }

"""Round-log aggregation — the numbers the benchmark tables consume.

``summarize_logs`` is ``repro.sim.metrics.summarize_logs``: it reduces
a list of per-round :class:`RoundLog` records to the scalar metrics of
the paper's tables (best/final accuracy, rounds completed, mean payload
bits, mean high-resolution fraction, cumulative latency, straggler
percentiles) plus the straggler-gap and async columns, which stay at
their sync defaults on the port's lockstep path.  ``write_metrics_csv``
writes sweep rows in the JAX package's column order.  The Monte-Carlo
replicate columns are not ported.
"""
from __future__ import annotations

import csv
import os
import tempfile
from typing import Dict, Iterable, List

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


# max_p (the batched phy solve's largest power coefficient) and
# resumed_from_round (checkpoint resume) are not filled on the port's
# host-solve path and stay blank, as in the JAX package's host-solve CSV.
METRIC_FIELDS = ["rounds", "best_acc", "final_acc", "mean_bits_per_user",
                 "mean_s", "total_latency_s", "mean_uplink_s",
                 "p95_uplink_s", "mean_straggler_gap_s",
                 "mean_staleness", "effective_participation",
                 "dropped_uploads", "quarantined_users",
                 "power_fallbacks", "resumed_from_round", "max_p"]


def write_metrics_csv(rows: Iterable[Dict], path: str) -> None:
    """Write sweep rows (scenario/quantizer/power + metrics) to CSV,
    atomically: the rows go to a temporary file in the target directory
    that then replaces ``path``, so no reader sees a torn file."""
    rows = list(rows)
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fields = ["scenario", "quantizer", "power"] + METRIC_FIELDS
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", suffix=".csv.tmp")
    try:
        with os.fdopen(fd, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise

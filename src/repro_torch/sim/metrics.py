"""Round-log aggregation — the numbers the benchmark tables consume.

``summarize_logs`` is ``repro.sim.metrics.summarize_logs``: it reduces
a list of per-round :class:`RoundLog` records to the scalar metrics of
the paper's tables (best/final accuracy, rounds completed, mean payload
bits, mean high-resolution fraction, cumulative latency, straggler
percentiles) plus the straggler-gap and async columns, which stay at
their sync defaults on the port's lockstep path.

``summarize_replicates`` lifts that row over the Monte-Carlo replicate
axis: each replicate's logs are summarized on their own, every metric
becomes the across-replicate mean under its own name, and
``<metric>_ci95`` carries the normal-approximation 95% half-width
``1.96 * std(ddof=1) / sqrt(R)`` (0 at R = 1).  ``write_metrics_csv``
writes sweep rows in the JAX package's column order.
"""
from __future__ import annotations

import csv
import os
import tempfile
from typing import Dict, Iterable, List, Sequence

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


def summarize_replicates(replicate_logs: Sequence[List]
                         ) -> Dict[str, float]:
    """Reduce R replicates' log lists to mean + ci95 columns: every
    ``summarize_logs`` metric under its own name as the across-replicate
    mean, ``<metric>_ci95`` (1.96 * standard error; 0.0 at R = 1) and a
    ``replicates`` count.  NaN metrics propagate as NaN means."""
    if not replicate_logs:
        raise ValueError("need at least one replicate")
    rows = [summarize_logs(logs) for logs in replicate_logs]
    R = len(rows)
    out: Dict[str, float] = {}
    for key in rows[0]:
        vals = np.array([row[key] for row in rows], dtype=np.float64)
        out[key] = float(np.mean(vals))
        out[key + "_ci95"] = float(
            1.96 * np.std(vals, ddof=1) / np.sqrt(R)) if R > 1 else 0.0
    out["replicates"] = float(R)
    return out


# max_p (the batched phy solve's largest power coefficient) is filled
# by the batched driver; it and resumed_from_round (checkpoint resume,
# not ported) stay blank on the host-solve path, as in the JAX
# package's CSV.
METRIC_FIELDS = ["rounds", "best_acc", "final_acc", "mean_bits_per_user",
                 "mean_s", "total_latency_s", "mean_uplink_s",
                 "p95_uplink_s", "mean_straggler_gap_s",
                 "mean_staleness", "effective_participation",
                 "dropped_uploads", "quarantined_users",
                 "power_fallbacks", "resumed_from_round", "max_p"]

# the replicated driver's extra columns, written only when some row
# carries them (unreplicated CSVs keep their schema); max_p and
# resumed_from_round are filled by the driver, so they carry no ci95
REPLICATE_FIELDS = ["replicates"] + [
    f + "_ci95" for f in METRIC_FIELDS
    if f not in ("max_p", "resumed_from_round")]


def write_metrics_csv(rows: Iterable[Dict], path: str) -> None:
    """Write sweep rows (scenario/quantizer/power + metrics) to CSV,
    atomically: the rows go to a temporary file in the target directory
    that then replaces ``path``, so no reader sees a torn file."""
    rows = list(rows)
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fields = ["scenario", "quantizer", "power"] + METRIC_FIELDS
    if any(f in row for f in REPLICATE_FIELDS for row in rows):
        fields += REPLICATE_FIELDS
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

"""Table III on the PyTorch/CUDA port — quantizers x power control
under a total latency budget.

The port of ``benchmarks/table3_latency.py``, with its quantizer and
power settings: for each quantizer (mixed-resolution lambda=0.4, b=4;
top-q q=0.01; LAQ b=4, xi=0.5; AQUILA b in 2..8, tol 0.05) and each
power control (the paper's bisection+LP, Dinkelbach with 4 outer and
15 inner steps, max-sum-rate with 20 steps and no restart), run FL over
the CFmMIMO channel under one latency budget and report T_max (rounds
completed), best test accuracy and mean payload bits.  The budget is
0.6 T rounds at the per-round latency of a 3-round LAQ probe under
bisection+LP.  Full mode is the paper's point (K=40, T=60, L=5, the
paper CNN at full width); ``--quick`` cuts it to K=6, T=8, L=3.

    python3 benchmarks/torch_table3_latency.py [--quick] [--device cpu]

Runs on the card unless ``--device`` says otherwise, as one quantizer x
power grid on ``repro_torch.sim.run_grid``, and writes
``runs/bench/torch_table3.csv`` with each cell's host seconds per power
solve.  Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import pathlib
import sys
import time

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.core.power import (BisectionLPPowerControl,  # noqa: E402
                                    DinkelbachPowerControl,
                                    MaxSumRatePowerControl, PowerController)
from repro_torch.core.quantize import LAQQuantizer  # noqa: E402
from repro_torch.sim import get_scenario, run_cell, run_grid  # noqa: E402

SIZES = {True: dict(K=6, T=8, L=3, n_train=1200, n_test=300),
         False: dict(K=40, T=60, L=5, n_train=8000, n_test=1600)}
FIELDS = ["quantizer", "power_control", "T_max", "best_acc", "mean_bits",
          "power_s_per_round"]


class TimedPower(PowerController):
    """Delegates to ``inner`` and keeps each solve's host seconds."""

    def __init__(self, inner: PowerController):
        self.inner, self.name, self.seconds = inner, inner.name, []

    def solve(self, chan, bits):
        t0 = time.perf_counter()
        try:
            return self.inner.solve(chan, bits)
        finally:
            self.seconds.append(time.perf_counter() - t0)


def run(quick: bool = True, device=None, out: str = "runs/bench"):
    os.makedirs(out, exist_ok=True)
    size = SIZES[quick]
    T = size["T"]
    scn = dataclasses.replace(
        get_scenario("paper-table3"), **size, batch_size=32, lr=0.01,
        eval_every=4)   # budget-capped runs still get evaluated

    lam, b = 0.4, 4
    s_ref = 0.01
    quantizers = {
        "mixed-resolution": ("mixed-resolution",
                             {"lambda_": lam, "b": b}),
        "top-q": ("top-q", {"q": max(s_ref, 0.005)}),
        "laq": ("laq", {"b": b, "xi": 0.5}),
        "aquila": ("aquila", {"b_min": 2, "b_max": 8, "tol": 0.05}),
    }
    powers = {
        "ours-bisection-lp": TimedPower(BisectionLPPowerControl()),
        "dinkelbach": TimedPower(DinkelbachPowerControl(outer=4, inner=15)),
        "max-sum-rate": TimedPower(MaxSumRatePowerControl(iters=20,
                                                          restarts=0)),
    }

    # budget: time for ~2/3 T rounds of classic-ish payload under our PC
    probe = run_cell(dataclasses.replace(scn, T=3),
                     LAQQuantizer(b=b, xi=0.5), BisectionLPPowerControl(),
                     quick=False, device=device)
    per_round = probe.result.logs[-1].cum_latency_s / 3
    budget = per_round * T * 0.6

    t0 = time.perf_counter()
    results = run_grid([scn], quantizers, powers, quick=False,
                       latency_budget_s=budget, device=device)
    grid_s = time.perf_counter() - t0
    # each power controller solves once a round, cell after cell in the
    # grid's order (quantizers outer, powers inner)
    used = {name: 0 for name in powers}
    rows, lines = [], []
    for res in results:
        pname = res.cell.power_label
        n = res.result.rounds_completed
        solves = powers[pname].seconds[used[pname]:used[pname] + n]
        used[pname] += n
        row = dict(quantizer=res.cell.quantizer_label, power_control=pname,
                   T_max=n, best_acc=res.summary["best_acc"],
                   mean_bits=res.summary["mean_bits_per_user"],
                   power_s_per_round=sum(solves) / max(n, 1))
        rows.append(row)
        lines.append(
            f"torch_table3/{row['quantizer']}/{pname},"
            f"Tmax={n};acc={row['best_acc']:.3f};"
            f"bits={row['mean_bits']:.2e};"
            f"power_s_per_round={row['power_s_per_round']:.6f}")
    lines.append(f"torch_table3/grid_seconds,{grid_s:.3f};"
                 f"budget_s={budget:.6f}")
    with open(os.path.join(out, "torch_table3.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="K=6, T=8, L=3 instead of the paper's point")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for line in run(quick=args.quick, device=args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

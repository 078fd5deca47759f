"""Table II on the PyTorch/CUDA port — accuracy of mixed-resolution FL
vs classic FL on the three datasets, IID and non-IID.

The port of ``benchmarks/table2_accuracy.py``, with its settings: K=20,
L=5, b=10, lambda=0.2, T=100, batch 48, 8000 training images a dataset
(synthetic stand-ins for CIFAR-10, CIFAR-100 and Fashion-MNIST), no
channel; ``--quick`` cuts it to K=6, T=10, L=3 on two datasets.  Each
(dataset, partition) cell is a Scenario, and the ours-vs-classic pair
is a quantizer grid on ``repro_torch.sim.run_grid``.

    python3 benchmarks/torch_table2_accuracy.py [--quick] [--device cpu]

Runs on the card unless ``--device`` says otherwise and writes
``runs/bench/torch_table2.csv``: best accuracy of each quantizer, the
mean high-resolution share s, the payload reduction against classic
(rbar) and the wall seconds a round.  Imports neither jax nor the JAX
package.
"""
from __future__ import annotations

import argparse
import csv
import os
import pathlib
import sys
import time

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.sim import Scenario, run_grid  # noqa: E402

SIZES = {True: dict(K=6, T=10, L=3, batch_size=32, n_train=1200,
                    datasets=("cifar10-syn", "fashion-syn")),
         False: dict(K=20, T=100, L=5, batch_size=48, n_train=8000,
                     datasets=("cifar10-syn", "cifar100-syn",
                               "fashion-syn"))}
FIELDS = ["setting", "acc_ours", "acc_classic", "s_pct", "rbar_pct",
          "s_per_round"]


def run(quick: bool = True, device=None, out: str = "runs/bench"):
    os.makedirs(out, exist_ok=True)
    size = dict(SIZES[quick])
    datasets = size.pop("datasets")
    n_train, T = size["n_train"], size["T"]

    quantizers = {
        "ours": ("mixed-resolution", {"lambda_": 0.2, "b": 10}),
        "classic": ("classic", {}),
    }
    lines, rows = [], []
    for ds in datasets:
        for iid in (True, False):
            tag = f"{ds}/{'iid' if iid else 'noniid'}"
            scn = Scenario(
                name=f"table2-{ds}-{'iid' if iid else 'noniid'}",
                description="Table II cell", dataset=ds,
                n_test=max(400, n_train // 5),
                partition="iid" if iid else "dirichlet",
                lr=0.01, M=None, eval_every=5, **size)
            t0 = time.perf_counter()
            results = run_grid([scn], quantizers, {"none": None},
                               quick=False, device=device)
            per_round = (time.perf_counter() - t0) / (2 * T)
            by = {r.cell.quantizer_label: r.summary for r in results}
            b = by["ours"]["best_acc"]
            c = by["classic"]["best_acc"]
            s_pct = 100 * by["ours"]["mean_s"]
            rbar = 100 * (1 - by["ours"]["mean_bits_per_user"]
                          / by["classic"]["mean_bits_per_user"])
            rows.append(dict(setting=tag, acc_ours=b, acc_classic=c,
                             s_pct=s_pct, rbar_pct=rbar,
                             s_per_round=per_round))
            lines.append(f"torch_table2/{tag},{per_round * 1e6:.1f},"
                         f"ours={b:.3f};classic={c:.3f};"
                         f"s={s_pct:.2f}%;rbar={rbar:.1f}%")
    with open(os.path.join(out, "torch_table2.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(rows)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="K=6, T=10, L=3 on two datasets")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for line in run(quick=args.quick, device=args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

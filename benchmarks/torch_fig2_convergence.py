"""Fig. 2 on the PyTorch/CUDA port — convergence of FL with
mixed-resolution quantization vs classic FL (non-IID), with the
average high-resolution fraction s.

The port of ``benchmarks/fig2_convergence.py``, with its settings: K=8
users over a Dirichlet(1.0) split of 8000 synthetic CIFAR-10-shaped
training images (800 test), L=5, batch 48, AdaGrad step 0.015, T=40
rounds evaluated every 5th, no channel; classic FL, mixed-resolution
at lambda=0.05 and at lambda=0.2 (b=10), each through the port's
``run_fl`` — the engine's exact mode, bit for bit the sequential
loop.  ``--quick`` cuts it to K=4, T=10, 1200 images.

    python3 benchmarks/torch_fig2_convergence.py [--quick] [--device cpu]

Runs on the card unless ``--device`` says otherwise and writes
``runs/bench/torch_fig2.csv`` (scheme, round, test accuracy, bits a
user); prints for each scheme its best accuracy, the payload reduction
against classic (rbar), s and the wall microseconds a round.  Imports
neither jax nor the JAX package.
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

from repro_torch.configs.paper_cnn import CIFAR10  # noqa: E402
from repro_torch.core.quantize import (ClassicQuantizer,  # noqa: E402
                                       MixedResolutionQuantizer)
from repro_torch.data import (make_image_classification,  # noqa: E402
                              partition_dirichlet)
from repro_torch.fl import FLConfig, run_fl  # noqa: E402

SIZES = {True: dict(K=4, T=10, n_train=1200, n_test=400),
         False: dict(K=8, T=40, n_train=8000, n_test=800)}
SCHEMES = {"classic": lambda: ClassicQuantizer(),
           "mixed-0.05": lambda: MixedResolutionQuantizer(lambda_=0.05, b=10),
           "mixed-0.2": lambda: MixedResolutionQuantizer(lambda_=0.2, b=10)}
FIELDS = ["scheme", "round", "test_acc", "bits_per_user"]


def run(quick: bool = True, device=None, out: str = "runs/bench"):
    os.makedirs(out, exist_ok=True)
    size = SIZES[quick]
    full = make_image_classification(
        n_samples=size["n_train"] + size["n_test"], hw=CIFAR10.input_hw,
        channels=CIFAR10.channels, n_classes=10, seed=0)
    train = dataclasses.replace(full, x=full.x[:size["n_train"]],
                                y=full.y[:size["n_train"]])
    test = dataclasses.replace(full, x=full.x[size["n_train"]:],
                               y=full.y[size["n_train"]:])
    shards = partition_dirichlet(train, size["K"], alpha=1.0, seed=0)
    fl = FLConfig(L=5, T=size["T"], batch_size=48, alpha=0.015,
                  eval_every=5)
    rows, summary = [], {}
    for name, make in SCHEMES.items():
        t0 = time.perf_counter()
        res = run_fl(train, test, shards, CIFAR10, make(), None, None, fl,
                     device=device)
        secs = time.perf_counter() - t0
        for log in res.logs:
            if log.test_acc is not None:
                rows.append([name, log.round, log.test_acc,
                             float(log.bits_per_user.mean())])
        best = max(l.test_acc for l in res.logs if l.test_acc is not None)
        summary[name] = (best, res.mean_bits(), res.mean_s(), secs)
    with open(os.path.join(out, "torch_fig2.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(FIELDS)
        w.writerows(rows)

    classic_bits = summary["classic"][1]
    lines = []
    for name, (best, bits, s, secs) in summary.items():
        rbar = 100 * (1 - bits / classic_bits)
        lines.append(f"torch_fig2/{name},{secs * 1e6 / max(fl.T, 1):.1f},"
                     f"best_acc={best:.3f};rbar={rbar:.1f}%;"
                     f"s={100 * s:.2f}%;seconds={secs:.3f}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="K=4, T=10, 1200 training images")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for line in run(quick=args.quick, device=args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

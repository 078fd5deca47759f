"""The batched power solvers on the PyTorch/CUDA port against the numpy
controllers looped over the realizations.

The port of ``benchmarks/phy_solvers.py``, with its settings: B=64
realizations (256 without ``--quick``) of ``CFmMIMOConfig(K=20, M=16)``,
payloads uniform in [1e5, 2e6] bits; bisection-LP at its defaults,
Dinkelbach at 4 outer x 10 inner steps and max-sum-rate at 40 steps
with 1 restart on both sides.  The batched solve runs in float32 (the
sweep driver's precision) on one bundle, warm, best of 3, each timing
closed by reading the latencies back to the host; the numpy loop is
timed once (the slow side).

    python3 benchmarks/torch_phy_solvers.py [--quick] [--device cpu]

Runs on the card unless ``--device`` says otherwise; prints one
``name,us_per_call,derived`` row per controller.  Imports neither jax
nor the JAX package.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.channel import CFmMIMOConfig, make_channel  # noqa: E402
from repro_torch.core.power import make_power_controller  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.phy import batched_solver, bundle_from_realizations  # noqa: E402

# reduced iteration counts keep the numpy side's forward-difference
# loops short; both sides use the same counts
CONTROLLERS = {"bisection": ("bisection-lp", {}),
               "dinkelbach": ("dinkelbach", {"outer": 4, "inner": 10}),
               "maxsum": ("max-sum-rate", {"iters": 40, "restarts": 1})}


def _time_batched(fn, reps: int = 3) -> float:
    fn()                                   # warm
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().latencies.cpu()               # wait for the device's results
        best = min(best, time.perf_counter() - t0)
    return best


def run(quick: bool = True, device=None):
    dev = resolve_device(device)
    B = 64 if quick else 256
    cfg = CFmMIMOConfig(K=20, M=16)
    chans = [make_channel(cfg, seed=s) for s in range(B)]
    cb = bundle_from_realizations(chans, device=dev)
    bits = np.random.default_rng(0).uniform(1e5, 2e6, (B, cfg.K))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    lines = []
    for label, (name, kw) in CONTROLLERS.items():
        ctrl = make_power_controller(name, **kw)
        t_batched = _time_batched(lambda: batched_solver(ctrl)(cb, bits))
        t0 = time.perf_counter()
        for i, c in enumerate(chans):
            ctrl.solve(c, bits[i])
        t_host = time.perf_counter() - t0
        lines.append(
            f"torch_phy_solvers/{label}_b{B},{t_batched * 1e6:.1f},"
            f"np_ms={t_host * 1e3:.1f};torch_ms={t_batched * 1e3:.1f};"
            f"speedup={t_host / t_batched:.1f}x;B={B};K={cfg.K};"
            f"device={where}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="B=64 realizations (else 256)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for line in run(quick=args.quick, device=args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Async rounds against lockstep on the PyTorch/CUDA port.

The port of ``benchmarks/async_rounds.py``, with its settings: K = 20
users with Zipf(1.3) shard sizes (``hetero-data`` cut to 1200/200
images, batch 8, L = 1), mixed-resolution(0.2, 4), max-sum-rate power
control (it leaves the per-user rates heavy-tailed, the regime async
rounds target), T = 6 rounds (20 without ``--quick``); the async side
closes each round at the median pending completion time with a depth-2
staleness buffer and alpha 0.5.  Both sides run through
``run_grid_batched``.  Two rows:

* ``wall`` — one whole job a side, setup included, closed by a
  synchronize on the card: the async machinery's cost (an extra
  aggregate call a round), not a speedup;
* ``simlat`` — the simulated uplink seconds a round (the event clock's
  round against the lockstep straggler), total simulated latency and
  the final accuracy of both sides.

    python3 benchmarks/torch_async_rounds.py [--quick] [--device cpu]

Runs on the card unless ``--device`` says otherwise.  Prints
``name,us_per_call,derived`` rows.  Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

import torch  # noqa: E402

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.sim import get_scenario, run_grid_batched  # noqa: E402

QUANT = {"mixed": ("mixed-resolution", {"lambda_": 0.2, "b": 4})}
POWER = {"maxsum": "max-sum-rate"}
K = 20


def scenarios(T: int):
    lockstep = dataclasses.replace(
        get_scenario("hetero-data"), name="async-bench-lockstep",
        K=K, T=T, n_train=1200, n_test=200, batch_size=8, L=1,
        partition="powerlaw")
    async_ = dataclasses.replace(
        lockstep, name="async-bench-async", async_mode=True,
        deadline_quantile=0.5, staleness_alpha=0.5, max_staleness=2)
    return lockstep, async_


def run(quick: bool = True, device=None):
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    T = 6 if quick else 20
    lockstep, async_ = scenarios(T)

    def job(scn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_grid_batched([scn], QUANT, POWER, quick=False,
                               device=dev)[0]
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0, res.summary

    job(dataclasses.replace(lockstep, T=1))       # process setup, untimed
    t_lock, s_lock = job(lockstep)
    t_async, s_async = job(async_)
    up_lock, up_async = s_lock["mean_uplink_s"], s_async["mean_uplink_s"]
    where = torch.cuda.get_device_name(dev) if cuda else "cpu"
    return [
        f"torch_async_rounds/wall-K{K},{t_async * 1e6:.1f},"
        f"lock_s={t_lock:.2f};async_s={t_async:.2f};"
        f"overhead={t_async / t_lock:.2f}x;T={T};"
        f"device={where}",
        f"torch_async_rounds/simlat-K{K},0.0,"
        f"uplink_ratio={up_lock / up_async:.2f}x;"
        f"sim_lock_s={s_lock['total_latency_s']:.3f};"
        f"sim_async_s={s_async['total_latency_s']:.3f};"
        f"acc_lock={s_lock['final_acc']:.3f};"
        f"acc_async={s_async['final_acc']:.3f};"
        f"eff_part={s_async['effective_participation']:.2f};"
        f"staleness={s_async['mean_staleness']:.2f};device={where}",
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="T=6 rounds (else 20)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for line in run(quick=args.quick, device=args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The replicate axis on the PyTorch/CUDA port against host-looped
Monte-Carlo replicates.

The port of ``benchmarks/mc_replicates.py``, with its settings: R=8
trajectories of one (``monte-carlo-channel`` cut to K=8, 480/96 images,
batch 8, L=1; mixed-resolution(0.2, 4); bisection-LP) cell.  The
replicated side is ``run_grid_batched(replicates=8)``: one replicated
train call per round and one batched solve of the 8 uplink problems.
The host-looped side is 8 unreplicated ``run_grid_batched`` runs, one
per seed.  Two rows:

* ``endtoend`` — one whole run per side at T_hi rounds (8, or 20
  without ``--quick``), problem build and engine setup included;
* ``steady`` — a T_hi-round run minus a 2-round run on each side, so
  the build and setup cancel and (T_hi - 2) rounds of stepping remain.

Each side first runs one untimed round, so the process's one-time
setup (the CUDA context, cuDNN and cuBLAS handles) falls on neither
side.

    python3 benchmarks/torch_mc_replicates.py [--quick] [--device cpu]

Runs on the card unless ``--device`` says otherwise; every timing ends
with a synchronize on the card.  Prints ``name,us_per_call,derived``
rows.  Imports neither jax nor the JAX package.
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
POWER = {"ours": "bisection-lp"}
R = 8
T_LO = 2


def _scenario(T: int, seed: int = 0):
    return dataclasses.replace(
        get_scenario("monte-carlo-channel"), name="mc-replicates-bench",
        K=8, T=T, n_train=480, n_test=96, batch_size=8, L=1, seed=seed)


def run(quick: bool = True, device=None):
    dev = resolve_device(device)

    def timed(fn) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    def repl_at(T):
        return run_grid_batched([_scenario(T)], QUANT, POWER, quick=False,
                                replicates=R, device=dev)

    def loop_at(T):
        # R unreplicated runs with per-replicate seeds (channel and data
        # geometry vary with the seed, as the replicate axis varies them)
        return [run_grid_batched([_scenario(T, seed=r)], QUANT, POWER,
                                 quick=False, device=dev) for r in range(R)]

    T_hi = 8 if quick else 20
    rounds = T_hi - T_LO
    repl_at(1)
    loop_at(1)
    t_repl_hi = timed(lambda: repl_at(T_hi))
    t_loop_hi = timed(lambda: loop_at(T_hi))
    t_repl = t_repl_hi - timed(lambda: repl_at(T_LO))
    t_loop = t_loop_hi - timed(lambda: loop_at(T_LO))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return [
        f"torch_mc_replicates/endtoend-R{R},{t_repl_hi * 1e6:.1f},"
        f"loop_s={t_loop_hi:.2f};repl_s={t_repl_hi:.2f};"
        f"speedup={t_loop_hi / t_repl_hi:.1f}x;R={R};T={T_hi};"
        f"device={where}",
        f"torch_mc_replicates/steady-R{R},{t_repl / rounds * 1e6:.1f},"
        f"loop_ms={t_loop * 1e3:.1f};repl_ms={t_repl * 1e3:.1f};"
        f"speedup={t_loop / t_repl:.1f}x;R={R};rounds={rounds};"
        f"device={where}",
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="T_hi=8 rounds (else 20)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for line in run(quick=args.quick, device=args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the replicate axis spends a round on the card.

    python3 tools/probe_replicates.py [--rounds 4] [--profile]

For two cells — ``benchmarks/torch_mc_replicates.py``'s
(``monte-carlo-channel`` cut to K=8, 480 images, batch 8, L=1) and
``monte-carlo-replicated`` at full width (K=20, L=5, batch 48) — with
mixed-resolution(0.2, 10) at R=8, on the card:

1. the replicated training step (``train_round_replicated``) with
   ``replicate_batching="vmap"`` and ``"map"``, beside R unreplicated
   ``train_round`` calls: median seconds a round over ``--rounds``
   rounds after one warm-up round (host clock, closed by a
   synchronize), split into the local training (``_batched_local``,
   called once a replicate in "map" and once under the vmap) and the
   rest of the step;
2. with ``--profile``, one vmap round under ``torch.profiler``: the
   ops with the most host time and the kernels launched.

Needs a CUDA card; imports neither jax nor the JAX package.  Prints the
card's name and power limit first.
"""
import argparse
import dataclasses
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CELLS = {
    "bench (K=8, L=1, batch 8)": ("monte-carlo-channel", dict(
        K=8, n_train=480, n_test=96, batch_size=8, L=1)),
    "monte-carlo-replicated (K=20, L=5, batch 48)": (
        "monte-carlo-replicated", {}),
}
R = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.sim import get_scenario, make_engine

    if not torch.cuda.is_available():
        print("probe_replicates: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    q = ("mixed-resolution", {"lambda_": 0.2, "b": 10})
    for label, (name, cut) in CELLS.items():
        scn = dataclasses.replace(get_scenario(name), T=args.rounds + 1,
                                  **cut)
        for mode in ("vmap", "map", "unreplicated"):
            eng = make_engine(scn, q, "bisection-lp", device="cuda")
            eng.engine_cfg = dataclasses.replace(
                eng.engine_cfg, replicate_batching=mode
                if mode != "unreplicated" else "auto")
            local = []
            real = eng._batched_local

            def timed_local(*a, _real=real):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*a)
                torch.cuda.synchronize()
                local.append(time.perf_counter() - t0)
                return out
            eng._batched_local = timed_local
            if mode == "unreplicated":
                states = [eng.start_run() for _ in range(R)]
                step = lambda t: [eng.train_round(s, t) for s in states]
            else:
                state = eng.start_replicated_run(R)
                step = lambda t: eng.train_round_replicated(state, t)
            walls, locs = [], []
            for t in range(1, args.rounds + 2):
                local.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(t)
                torch.cuda.synchronize()
                if t > 1:
                    walls.append(time.perf_counter() - t0)
                    locs.append(sum(local))
            wall, loc = statistics.median(walls), statistics.median(locs)
            print(f"{label}, {mode}: {wall:.6f} s a round (R={R}), local "
                  f"training {loc:.6f} s, the rest {wall - loc:.6f} s")
            if args.profile and mode == "vmap":
                from torch.profiler import ProfilerActivity, profile
                eng._batched_local = real
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    step(args.rounds + 2)
                    torch.cuda.synchronize()
                print(prof.key_averages().table(
                    sort_by="self_cpu_time_total", row_limit=15))
            del eng
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Quickstart on the PyTorch/CUDA port: FL with adaptive
mixed-resolution quantization + power control over a CFmMIMO channel
(Algorithm 1) on ``repro_torch.sim``'s engine, then a churn sweep.

    python3 examples/quickstart_torch.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``, with its sizes.
Part 1 runs the paper's ours-vs-classic comparison through the engine
directly (the fused step); part 2 shows the scenario/sweep API the
benchmark tables are built on, on a small churn scenario (every user
takes part in a round with probability 0.7), writing
``runs/quickstart_torch_sweep.csv``.  Runs on the card unless
``--device`` says otherwise (about a minute on the CPU); imports
neither jax nor the JAX package.
"""
import argparse
import dataclasses
import pathlib
import sys

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.configs.paper_cnn import PaperCNNConfig  # noqa: E402
from repro_torch.core.channel import CFmMIMOConfig, make_channel  # noqa: E402
from repro_torch.core.power import BisectionLPPowerControl  # noqa: E402
from repro_torch.core.quantize import (ClassicQuantizer,  # noqa: E402
                                       MixedResolutionQuantizer)
from repro_torch.data import (make_image_classification,  # noqa: E402
                              partition_dirichlet)
from repro_torch.fl import FLConfig  # noqa: E402
from repro_torch.sim import (EngineConfig, Scenario,  # noqa: E402
                             VectorizedFLEngine, run_grid)


def engine_demo(device=None):
    """Ours vs classic on one channel realization, engine API."""
    K = 8
    full = make_image_classification(n_samples=2400, hw=16, n_classes=4,
                                     seed=0)
    train = dataclasses.replace(full, x=full.x[:2000], y=full.y[:2000])
    test = dataclasses.replace(full, x=full.x[2000:], y=full.y[2000:])
    cfg = PaperCNNConfig(input_hw=16, n_classes=4)
    shards = partition_dirichlet(train, K, alpha=0.3)
    chan = make_channel(CFmMIMOConfig(K=K), seed=0)
    fl = FLConfig(L=5, T=12, batch_size=48, alpha=0.01, eval_every=4)
    fused = EngineConfig(fused=True)   # all users in one vmap a round

    print("== mixed-resolution (ours) + bisection-LP power control ==")
    ours = VectorizedFLEngine(train, test, shards, cfg,
                              MixedResolutionQuantizer(lambda_=0.05, b=10),
                              BisectionLPPowerControl(), chan, fl,
                              engine=fused, device=device).run(verbose=True)

    print("== classic FL (32-bit), same channel ==")
    classic = VectorizedFLEngine(train, test, shards, cfg,
                                 ClassicQuantizer(),
                                 BisectionLPPowerControl(), chan, fl,
                                 engine=fused, device=device
                                 ).run(verbose=True)

    rbar = 100 * (1 - ours.mean_bits() / classic.mean_bits())
    speedup = (classic.logs[-1].cum_latency_s
               / max(ours.logs[-1].cum_latency_s, 1e-9))
    print(f"\ncommunication overhead reduction r-bar = {rbar:.1f}%")
    print(f"high-resolution fraction s = {100 * ours.mean_s():.2f}%")
    print(f"wall-clock (simulated) round-latency speedup = {speedup:.1f}x")
    print(f"final accuracy: ours={ours.final_acc:.3f} "
          f"classic={classic.final_acc:.3f}")


def sweep_demo(device=None, out_csv="runs/quickstart_torch_sweep.csv"):
    """Scenario x quantizer sweep under churn — the benchmark-table
    workflow."""
    scn = Scenario(name="quickstart-churn",
                   description="small churn scenario",
                   dataset="fashion-syn", n_train=800, n_test=200,
                   K=6, T=6, L=2, batch_size=16, participation=0.7)
    results = run_grid(
        [scn],
        quantizers={"ours": ("mixed-resolution",
                             {"lambda_": 0.2, "b": 10}),
                    "classic": ("classic", {})},
        powers={"ours-pc": "bisection-lp"},
        quick=False, out_csv=out_csv, device=device)
    print(f"\n== sweep results ({out_csv}) ==")
    for r in results:
        row = r.row()
        print(f"{row['scenario']:>18s} {row['quantizer']:>8s}: "
              f"acc={row['best_acc']:.3f} "
              f"bits/user={row['mean_bits_per_user']:.2e} "
              f"latency={row['total_latency_s']:.2f}s "
              f"participation={row['effective_participation']:.2f}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    engine_demo(args.device)
    sweep_demo(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

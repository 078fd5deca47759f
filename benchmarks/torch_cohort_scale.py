"""Streaming-cohort user-axis scaling on the PyTorch/CUDA port.

The port of ``benchmarks/cohort_scale.py``, with its settings: one
sample a user, L = 1 and batch 1, mixed-resolution(0.2, 10) on the
packed plane, no channel; cohorts of C = 8 at K = 20 and C = 256 at
K = 2,000 and 20,000 (K = 20,000 only without ``--quick``).  JAX's
driver checks the memory claim by walking the traced step; the port
measures it:

* ``peak_K{K}`` — on the card, the round's peak device memory above
  what was held before it (``torch.cuda.max_memory_allocated``), beside
  K*d*4 and C*d*4; on the CPU, the largest tensor holding d that one
  round creates (a ``TorchDispatchMode`` over the round), which must be
  the cohort stack [C, d], never [K, d];
* ``round_K{K}`` — one round's wall time after a warm-up round,
  closed by a synchronize on the card.

The model is JAX's narrow CNN (8x8 inputs, 4 filters, 8 dense units);
``chip_smoke.py`` runs the same rounds with the paper CNN at full width.

    python3 benchmarks/torch_cohort_scale.py [--quick] [--device cpu]

Runs on the card unless ``--device`` says otherwise.  Prints
``name,us_per_call,derived`` rows.  Imports neither jax nor the JAX
package.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.configs.paper_cnn import PaperCNNConfig  # noqa: E402
from repro_torch.core.quantize import MixedResolutionQuantizer  # noqa: E402
from repro_torch.data import make_image_classification  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.fl.loop import FLConfig  # noqa: E402
from repro_torch.kernels import WirePath  # noqa: E402
from repro_torch.sim import EngineConfig, VectorizedFLEngine  # noqa: E402

COHORT = {20: 8, 2_000: 256, 20_000: 256}
NARROW = PaperCNNConfig(input_hw=8, channels=3, conv_filters=4,
                        dense_units=8, n_classes=2)


def make(K: int, device) -> VectorizedFLEngine:
    ds = make_image_classification(n_samples=K + 200, hw=NARROW.input_hw,
                                   n_classes=NARROW.n_classes, noise=0.3,
                                   seed=0)
    train = dataclasses.replace(ds, x=ds.x[:K], y=ds.y[:K])
    test = dataclasses.replace(ds, x=ds.x[K:], y=ds.y[K:])
    return VectorizedFLEngine(
        train, test, [np.array([i]) for i in range(K)], NARROW,
        MixedResolutionQuantizer(0.2, 10), None, None,
        FLConfig(T=2, L=1, batch_size=1, seed=0, eval_every=1),
        engine=EngineConfig(wire=WirePath(plane="packed",
                                          cohort_size=COHORT[K])),
        device=device)


class LargestD(TorchDispatchMode):
    """The largest numel of the op outputs that hold dimension d."""

    def __init__(self, d: int):
        super().__init__()
        self.d, self.shape = d, ()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and self.d in t.shape \
                    and t.numel() > int(np.prod(self.shape)):
                self.shape = tuple(t.shape)
        return out


def run(quick: bool = True, device=None):
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    where = torch.cuda.get_device_name(dev) if cuda else "cpu"
    rows = []
    for K in (20, 2_000) + (() if quick else (20_000,)):
        eng, C = make(K, dev), COHORT[K]
        d = eng.d
        state = eng.start_run()
        eng.train_round(state, 1)                      # warm-up
        if cuda:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if cuda:
            work = eng.train_round(state, 2)
            torch.cuda.synchronize()
        else:
            with LargestD(d) as probe:
                work = eng.train_round(state, 2)
        wall = time.perf_counter() - t0
        if not np.all(np.isfinite(work.bits_np)):
            raise AssertionError(f"K={K}: non-finite bits")
        if cuda:
            peak = torch.cuda.max_memory_allocated() - held
            what = "device_peak_above_held_bytes"
        else:
            if K in probe.shape or int(np.prod(probe.shape)) > C * d:
                raise AssertionError(f"K={K}: a {probe.shape} tensor holds "
                                     "the user axis with d")
            peak = int(np.prod(probe.shape)) * 4
            what = f"largest_d_tensor={list(probe.shape)};bytes"
        rows.append(f"torch_cohort_scale/peak_K{K},0,{what}={peak};C={C};"
                    f"d={d};dense_Kd_bytes={K * d * 4};"
                    f"cohort_Cd_bytes={C * d * 4};device={where}")
        rows.append(f"torch_cohort_scale/round_K{K},{wall * 1e6:.1f},"
                    f"d={d};C={C};bits_mean={work.bits_np.mean():.1f};"
                    f"device={where}")
        del eng, state, work
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="K = 20 and 2,000 (else also 20,000)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for line in run(quick=args.quick, device=args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

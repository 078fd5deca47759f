"""Per-layer budget overhead on the PyTorch/CUDA port.

The port of ``benchmarks/layer_budget.py``, with its settings: a
transformer-shaped toy tree (an embedding and a matmul of d_mat
entries each, a gain of d_norm) under
``LayerBudget.by_group(embed=(0.4, 4), norm=(0.05, 12), matmul=(0.2,
10))``, K = 8 users and d_mat = 65,536, d_norm = 1,024 (K = 20,
d_mat = 1,048,576, d_norm = 4,096 without ``--quick``).  On the same
``[K, d]`` deltas it times the global ``mixed_res_wire_aggregate``
(K1, K2, K3 once), ``segmented_wire_aggregate`` (once a segment: 3)
and the dense plane's ``segmented_quantize``, best of 10 calls after a
warm-up, each closed by a synchronize on the card.

    python3 benchmarks/torch_layer_budget.py [--quick] [--device cpu]

Runs on the card unless ``--device`` says otherwise.  Prints
``name,us_per_call,derived`` rows.  Imports neither jax nor the JAX
package.
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

from repro_torch.core.quantize import (LayerBudget,  # noqa: E402
                                       segmented_quantize)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.ops import (mixed_res_wire_aggregate,  # noqa: E402
                                     segmented_wire_aggregate)

LAM, B = 0.2, 10


def run(quick: bool = True, device=None):
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    K = 8 if quick else 20
    d_mat = 65536 if quick else 1048576
    d_norm = 1024 if quick else 4096
    tree = {"a_embed_tokens": torch.zeros(d_mat // 256, 256),
            "b_ln": torch.zeros(d_norm),
            "c_w": torch.zeros(d_mat // 256, 256)}
    segments = LayerBudget.by_group(
        embed=(0.4, 4), norm=(0.05, 12), matmul=(LAM, B)).segments_for(
        tree, LAM, B)
    d = segments[-1].stop
    flat = torch.tensor(np.random.default_rng(0).standard_normal((K, d)),
                        dtype=torch.float32, device=dev)
    w = torch.full((K,), 1.0 / K, device=dev)

    def best_us(fn, n=10):
        fn()
        best = float("inf")
        for _ in range(n):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6

    t_glob = best_us(lambda: mixed_res_wire_aggregate(flat, w, LAM, B))
    t_seg = best_us(lambda: segmented_wire_aggregate(flat, w, segments))
    t_dense = best_us(lambda: segmented_quantize(flat, segments))
    where = torch.cuda.get_device_name(dev) if cuda else "cpu"
    n = len(segments)
    return [
        f"torch_layer_budget/wire_global_K{K}_d{d},{t_glob:.1f},"
        f"one_global_segment;device={where}",
        f"torch_layer_budget/wire_segmented_K{K}_d{d},{t_seg:.1f},"
        f"{n}seg_ratio={t_seg / t_glob:.2f}x;device={where}",
        f"torch_layer_budget/dense_segmented_K{K}_d{d},{t_dense:.1f},"
        f"{n}seg_dense_plane;device={where}",
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="K=8, d_mat=65,536 (else K=20, d_mat=1,048,576)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for line in run(quick=args.quick, device=args.device):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

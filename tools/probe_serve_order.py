#!/usr/bin/env python3
"""Whether ``chip_smoke.py``'s cohort, budget and async phases, or a
``torch.profiler`` session, slow the serve path's decode that runs
after them in the same process.

    python3 tools/probe_serve_order.py [--turns 3]

On the card, in one process: builds the kernels
(``chip_smoke.build_all``), then takes four serve points, each with
full-width granite-3-8b (random bf16 weights from a seed, B=8, made
anew and freed after): ``greedy_generate`` as ``chip_smoke.py`` serves
(16 prompt tokens, 48 generated; ms a decode step) and decode at a short
context and at a nearly full cache in turns
(``chip_smoke.alternate_lengths``, ``--turns`` of each, medians).

1. ``alone``: before any other phase;
2. ``profiled``: after one ``torch.profiler`` session (CPU and CUDA
   activities) around a small matmul on the card;
3. ``after``: then after ``chip_smoke.user_axis_and_round_modes`` has run
   all six of its phases, with nothing freed but what their return
   freed;
4. ``freed``: then after ``gc.collect()`` and
   ``torch.cuda.empty_cache()``.

At each point it also prints the device memory still allocated before
the weights are made and the number of objects the garbage collector
tracks; before ``freed``, what the collection found and its seconds.
Prints the card's name and power limit first and a JSON line of the
four points last.  Needs a CUDA card; imports neither jax nor the JAX
package.
"""
import argparse
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ and tests/ on sys.path)


def serve_point(dev, label, turns):
    """One serve point: the weights made, ``greedy_generate`` timed, the
    turns of short and full-cache decode, the weights freed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import cast_params, greedy_generate

    held = torch.cuda.memory_allocated() / 2**30
    tracked = len(gc.get_objects())
    cfg = get_config(chip_smoke.SERVE["arch"])
    params = cast_params(init_model(
        torch.Generator(device=dev).manual_seed(0), cfg, device=dev),
        cfg.dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    B, P = chip_smoke.SERVE["B"], chip_smoke.SERVE["prompt"]
    prompts = torch.tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, P)), device=dev)
    res = greedy_generate(params, cfg, prompts, chip_smoke.SERVE["gen"],
                          chip_smoke.SERVE["max_len"])
    serve_ms = 1e3 * res.decode_s / res.decode_steps
    med = chip_smoke.alternate_lengths(params, cfg, prompts, turns=turns)
    del params, prompts, res
    torch.cuda.empty_cache()
    print(f"[{label}] held before the weights {held:.3f} GiB, gc tracks "
          f"{tracked} objects; serve "
          f"decode {serve_ms:.3f} ms/step; turns medians short "
          f"{med['short']:.3f}, full {med['full']:.3f} ms/step", flush=True)
    return {"held_gib": held, "gc_objects": tracked,
            "serve_ms_step": serve_ms,
            "short_ms_step": med["short"], "full_ms_step": med["full"]}


def profile_once(dev):
    """One profiler session around a small matmul on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x @ x).sum().item()
    torch.cuda.synchronize()


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_serve_order: needs a CUDA card", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    chip_smoke.build_all()
    points = {"alone": serve_point(dev, "alone", args.turns)}
    profile_once(dev)
    points["profiled"] = serve_point(dev, "profiled", args.turns)
    t0 = time.perf_counter()
    chip_smoke.user_axis_and_round_modes(dev, {})
    print(f"the six phases: {time.perf_counter() - t0:.1f} s")
    points["after"] = serve_point(dev, "after", args.turns)
    t0 = time.perf_counter()
    found = gc.collect()
    torch.cuda.empty_cache()
    print(f"gc.collect() found {found} unreachable objects in "
          f"{time.perf_counter() - t0:.3f} s")
    points["freed"] = serve_point(dev, "freed", args.turns)
    print(json.dumps(points))
    return 0


if __name__ == "__main__":
    sys.exit(main())

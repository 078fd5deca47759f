#!/usr/bin/env python3
"""Whether the engine's exact mode can keep its bit-for-bit contract on
the card, and what its per-user training costs there.

    python3 tools/probe_exact_mode.py [--repeats 5]

On one round's minibatches of full-width ``paper-table3`` (K=40 users,
the paper CNN, d=462,410, L=5 AdaGrad steps of batch 32) on the card:

1. each user's ``local_delta`` (the one per-user call of the exact mode
   and of ``run_fl_sequential``) called ``--repeats`` times on the same
   inputs, under the default cuDNN flags and inside
   ``torch.backends.cudnn.deterministic = True`` and ``benchmark =
   False``, set for the calls and restored after:
   how many users ever gave other bits than their first call;
2. the 40 per-user calls timed under both flag settings, beside the
   fused mode's one ``vmap`` over the users (host clock, each closed by
   a synchronize; median of ``--repeats``);
3. the largest gap between the ``vmap`` deltas and the per-user deltas
   on the card, against the largest delta.

Needs a CUDA card; imports neither jax nor the JAX package.  Prints the
card's name and power limit first.
"""
import argparse
import contextlib
import dataclasses
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_exact_mode: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.quantize import MixedResolutionQuantizer
    from repro_torch.fl.loop import local_delta
    from repro_torch.sim import get_scenario, make_engine

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    scn = dataclasses.replace(get_scenario("paper-table3"), fused=False,
                              T=1)
    eng = make_engine(scn, MixedResolutionQuantizer(0.2, 10),
                      "bisection-lp", device="cuda")
    state = eng.start_run()
    xs, ys = eng.draw_minibatches(state)
    params, fl, loss = state.params, eng.fl, eng.model_spec.loss
    one = lambda j: local_delta(params, xs[j], ys[j], fl.L, fl.alpha, loss)
    cudnn = torch.backends.cudnn

    @contextlib.contextmanager
    def deterministic():
        # only these two flags: cudnn.flags() would also reset enabled,
        # allow_tf32 and the fp32 precision to its own defaults
        prev = cudnn.deterministic, cudnn.benchmark
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            yield
        finally:
            cudnn.deterministic, cudnn.benchmark = prev

    settings = {"default cuDNN flags": contextlib.nullcontext,
                "cudnn deterministic=True, benchmark=False": deterministic}

    def per_user():
        return torch.stack([one(j) for j in range(eng.K)])

    def timed(fn):
        out, secs = None, []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, secs

    with torch.no_grad():
        eng._batched_local(params, xs, ys)            # warm up
        per_user()
        flats = {}
        for label, scope in settings.items():
            with scope():
                first = per_user()
                differ = set()
                for _ in range(args.repeats - 1):
                    again = per_user()
                    for j in range(eng.K):
                        if not torch.equal(first[j].view(torch.int32),
                                           again[j].view(torch.int32)):
                            differ.add(j)
                flats[label], secs = timed(per_user)
            print(f"{label}: {len(differ)} of {eng.K} users gave other "
                  f"bits than their first call in {args.repeats} calls "
                  f"{sorted(differ)}; 40 per-user calls "
                  f"{statistics.median(secs):.6f} s (median of "
                  f"{args.repeats}: {[round(s, 6) for s in secs]})")
        a, b = flats.values()
        print(f"default vs deterministic flags: bit for bit "
              f"{torch.equal(a.view(torch.int32), b.view(torch.int32))}, "
              f"max abs gap {float((a - b).abs().max()):.3e}")
        vm, secs = timed(lambda: eng._batched_local(params, xs, ys))
        gap = float((vm - a).abs().max())
        print(f"vmap over the 40 users (the fused mode): "
              f"{statistics.median(secs):.6f} s (median of {args.repeats});"
              f" bit for bit the per-user calls "
              f"{torch.equal(vm.view(torch.int32), a.view(torch.int32))}, "
              f"max abs gap {gap:.3e} against max |delta| "
              f"{float(a.abs().max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

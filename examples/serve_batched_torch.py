"""Batched greedy serving through the PyTorch port: prefill a batch of
random prompts token by token, then decode greedily with the static KV
cache; on the card every attention layer runs kernel K6.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch granite-3-8b
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu --reduced

Weights are random (``--seed``), made at full width unless
``--reduced`` (the CPU smoke variant of the family).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_model, param_count
from repro_torch.serve import cast_params, greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=None,
                    help="cache positions (default prompt-len + gen)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the family's 2-layer CPU smoke variant")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"dtype={cfg.dtype} device={dev}")
    params = init_model(torch.Generator(device=dev).manual_seed(args.seed),
                        cfg, device=dev)
    n_params = param_count(params)
    params = cast_params(params, cfg.dtype)     # once, when serving starts
    rng = np.random.default_rng(args.seed)
    prompts = torch.tensor(rng.integers(1, cfg.vocab_size,
                                        (args.batch, args.prompt_len)),
                           device=dev)
    res = greedy_generate(params, cfg, prompts, args.gen, args.max_len)
    B, P = prompts.shape
    print(f"params {n_params}; prefill: {P} tokens x {B} seqs in "
          f"{res.prefill_s:.3f} s")
    if res.decode_steps:
        n = res.decode_steps * B
        print(f"decode: {res.decode_steps} steps x {B} seqs in "
              f"{res.decode_s:.3f} s -> "
              f"{1e3 * res.decode_s / res.decode_steps:.2f} ms/step, "
              f"{n / res.decode_s:.1f} tok/s on {dev}")
    print("sample token ids:", res.tokens[0, :12].cpu().numpy())
    return res


if __name__ == "__main__":
    main()

"""Batched greedy serving of a dense decoder — the loop of the JAX
package's ``examples/serve_batched.py`` as a function.

:func:`greedy_generate` allocates the static KV cache, feeds the
prompts token by token through ``decode_step`` (the prefill), then
decodes greedily: each step's token is the argmax of
``logits[..., :vocab_size]``.  On the card every attention layer of
every step runs kernel K6.  The next write position lives on the
device and is advanced there, and tokens stay on the device, so the
loop never waits for the card until it ends.

The JAX package keeps float32 masters and casts them at each use; the
port's caller casts them to the config's dtype once, when serving starts
(:func:`cast_params`, which frees the float32 masters) — the same
numbers, read once a token in the compute dtype instead of in float32.
:func:`greedy_generate` takes the cast params and checks their dtype.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import (decode_step, init_cache,
                                            torch_dtype)


class ServeResult(NamedTuple):
    tokens: torch.Tensor        # [B, gen] generated ids, on the device
    prefill_s: float            # host clock, ending in a synchronize
    decode_s: float
    decode_steps: int           # gen - 1 (the first token ends the prefill)


def cast_params(params: dict, dtype) -> dict:
    """Floating leaves cast to ``dtype`` (no copy where they already
    are)."""
    dt = torch_dtype(dtype)
    return tree_map(lambda t: t.to(dt) if t.is_floating_point() else t,
                    params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(params: dict, cfg: ModelConfig, prompts: torch.Tensor,
                    gen: int, max_len: Optional[int] = None) -> ServeResult:
    """prompts: [B, P] token ids on the params' device; ``gen`` >= 1
    tokens are generated into a cache of ``max_len`` (default P + gen)
    positions.  Floating params must be in ``cfg.dtype``
    (:func:`cast_params`)."""
    B, P = prompts.shape
    max_len = max_len or P + gen
    if gen < 1 or max_len < P + gen - 1:
        raise ValueError(f"need gen >= 1 and max_len >= prompt + gen - 1, "
                         f"got gen={gen} max_len={max_len} prompt={P}")
    dt = torch_dtype(cfg.dtype)
    wrong = {str(t.dtype) for t in tree_leaves(params)
             if t.is_floating_point() and t.dtype != dt}
    if wrong:
        raise ValueError(f"params hold {sorted(wrong)}, not {dt}: cast "
                         f"them once with cast_params")
    dev = prompts.device
    cache = init_cache(cfg, B, max_len, cfg.dtype, device=dev)
    idx = torch.zeros((), dtype=torch.int32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(P):
        logits, cache = decode_step(params, cache, prompts[:, t:t + 1], idx,
                                    cfg)
        idx += 1
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
    _sync(dev)
    t1 = time.perf_counter()
    generated = [tok]
    for _ in range(gen - 1):
        logits, cache = decode_step(params, cache, tok, idx, cfg)
        idx += 1
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
        generated.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return ServeResult(torch.cat(generated, dim=1), t1 - t0, t2 - t1,
                       gen - 1)

"""Top-q sparsification benchmark [Wangni et al., NeurIPS 2018].

Only the q-fraction largest-magnitude entries are transmitted; each
kept entry costs 32 value bits + ceil(log2 d) index bits; dropped
entries are reconstructed as zero.  Op for op
``repro.core.quantize.topq``.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from .base import QuantResult, Quantizer


def topq_quantize(delta: torch.Tensor, q: float) -> QuantResult:
    """The threshold is the k-th largest magnitude, the same value
    whatever order ``torch.topk`` gives ties in; the mask keeps every
    element at or above it, ties included.  ``aux["k"]`` is an int32
    tensor, so the result batches under ``torch.func.vmap``."""
    x = delta.to(torch.float32)
    d = x.numel()
    k = max(1, int(math.ceil(q * d)))
    absx = torch.abs(x)
    thresh = torch.topk(absx, k).values[-1]
    mask = absx >= thresh
    recon = torch.where(mask, x, torch.zeros_like(x))
    idx_bits = math.ceil(math.log2(max(d, 2)))
    bits = torch.full((), float(k) * (32.0 + idx_bits), dtype=torch.float32,
                      device=x.device)
    aux = {"s": torch.full_like(bits, k / d),
           "k": torch.full((), k, dtype=torch.int32, device=x.device)}
    return QuantResult(recon=recon, bits=bits, aux=aux)


class TopQQuantizer(Quantizer):
    name = "top-q"

    def __init__(self, q: float = 0.01):
        if not (0.0 < q <= 1.0):
            raise ValueError(f"q must be in (0,1], got {q}")
        self.q = float(q)

    def __call__(self, delta, state: Any = None) -> Tuple[QuantResult, Any]:
        return topq_quantize(delta, self.q), state

"""AQUILA-style adaptive bit-width benchmark [Zhao et al., TMC 2024].

Picks the smallest ``b in {b_min..b_max}`` whose b-bit uniform
quantization has a relative l2 error of at most ``tol`` (``b_max`` when
none does).  Payload: d*b + 32 bits.  Op for op
``repro.core.quantize.aquila``.

Each candidate reconstruction is bit for bit the JAX package's (it is
elementwise given ``max|x|``); ``rel_err`` is a norm, whose value
depends on the order of the reduction, so a candidate whose error lies
within roundoff of ``tol`` may be accepted by one package and refused
by the other.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .base import QuantResult, Quantizer
from .laq import _uniform_quantize


def aquila_quantize(delta: torch.Tensor, b_min: int, b_max: int, tol: float
                    ) -> QuantResult:
    """One user's AQUILA step; ``tol`` is rounded to float32 before the
    compare, as JAX does implicitly."""
    x = delta.to(torch.float32)
    d = x.numel()
    norm = torch.linalg.vector_norm(x)
    safe_norm = torch.where(norm > 0, norm, torch.ones_like(norm))

    # candidate reconstructions for every allowed bit-width
    recons = torch.stack([_uniform_quantize(x, b)
                          for b in range(b_min, b_max + 1)])
    rel_err = torch.linalg.vector_norm(recons - x[None, :], dim=1) / safe_norm
    ok = (rel_err <= float(np.float32(tol))).to(torch.int32)
    # index of the smallest acceptable b (argmax takes the first of
    # equal maxima); fall back to b_max if none pass
    first_ok = torch.argmax(ok)
    idx = torch.where(ok.amax() > 0, first_ok,
                      torch.full_like(first_ok, recons.shape[0] - 1))
    pick = idx.reshape(1)
    recon = torch.index_select(recons, 0, pick)[0]
    b_sel = (b_min + idx).to(torch.int32)
    bits = torch.full_like(norm, float(d)) * b_sel.to(torch.float32) + 32.0
    aux = {"s": torch.ones_like(norm), "b_selected": b_sel,
           "rel_err": torch.index_select(rel_err, 0, pick)[0]}
    return QuantResult(recon=recon, bits=bits, aux=aux)


class AquilaQuantizer(Quantizer):
    name = "aquila"

    def __init__(self, b_min: int = 2, b_max: int = 8, tol: float = 0.05):
        if b_min < 2 or b_max < b_min:
            raise ValueError("need 2 <= b_min <= b_max")
        self.b_min, self.b_max, self.tol = int(b_min), int(b_max), float(tol)

    def __call__(self, delta, state: Any = None) -> Tuple[QuantResult, Any]:
        return aquila_quantize(delta, self.b_min, self.b_max, self.tol), state

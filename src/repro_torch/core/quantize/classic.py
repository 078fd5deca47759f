"""Classic FL baseline: full-precision (32-bit) transmission."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .base import QuantResult, Quantizer


class ClassicQuantizer(Quantizer):
    """No compression — every element costs 32 bits.  ``bits`` is f32,
    as in the JAX package (x64 off)."""

    name = "classic"

    def __call__(self, delta, state: Any = None) -> Tuple[QuantResult, Any]:
        x = delta.to(torch.float32)
        bits = torch.full((), 32.0 * x.numel(), dtype=torch.float32,
                          device=x.device)
        return QuantResult(recon=x, bits=bits,
                           aux={"s": torch.ones_like(bits)}), state

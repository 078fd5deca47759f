"""Adaptive mixed-resolution quantization — the paper's §II-C scheme.

Element-wise two-category quantization of a local gradient vector
``delta`` (d elements):

* high-resolution — elements with ``|x_i| / ||x||_inf >= lambda_`` are
  uniformly quantized with ``b`` bits on the grid ``[dw_q, ||x||_inf]``
  of radius ``r = ||x||_inf - dw_q``, where ``dw_q`` is the smallest
  magnitude among high-resolution elements (eq. 6-7);
* low-resolution — every other element is sent as a single sign bit and
  reconstructed as ``± dw_q_hat / 2`` (eq. 8).

Total payload: ``b_t = d (b s + 1 - s) + 32`` bits with ``s = dbar / d``
the high-resolution fraction.

This module is op for op the same arithmetic as
``repro.core.quantize.mixed_resolution``.  It runs per user under
``torch.func.vmap`` (:meth:`Quantizer.batched`) on the dense and
signplane wire planes; the packed plane's encode
(``repro_torch.kernels.ops``) never materializes the dense ``recon``.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import true_div

from .base import QuantResult, Quantizer

_F32_BITS = 32.0


def lemma1_bound(lambda_: float, b: int) -> float:
    """The constant ``c_j`` of Lemma 1, eq. (9) — as printed in the
    paper (holds under the no-gap condition; see the JAX module)."""
    hi = (1.0 - lambda_) / (2.0 * (2 ** b - 1))
    lo = lambda_ / 2.0 + (1.0 - lambda_) / (4.0 * (2 ** b - 1))
    return max(lo, hi)


def lemma1_bound_realized(lambda_: float, b: int, rho: float) -> float:
    """Corrected Lemma 1 constant given ``rho = dw_q / ||x||_inf``,
    valid whatever the gap at the threshold (see the JAX module):

    * high-res: ``|eps| <= (1 - rho) / (2 (2^b - 1)) ||x||_inf``;
    * low-res:  ``|eps| <= max(rho / 2, lambda - rho / 2) ||x||_inf``.

    Reduces to eq. (9)'s low branch when ``rho == lambda`` (no gap)."""
    hi = (1.0 - rho) / (2.0 * (2 ** b - 1))
    lo = max(rho / 2.0, lambda_ - rho / 2.0)
    return max(lo, hi)


def mixed_resolution_quantize(delta: torch.Tensor, lambda_: float, b: int
                              ) -> QuantResult:
    """Quantize one flat vector; batchable under ``torch.func.vmap``.

    ``lambda_`` is rounded to float32 before the threshold compare, as
    JAX does implicitly: a compare in double flips elements that sit on
    the threshold.  Every division is IEEE on CUDA too: tensor by
    tensor, or :func:`true_div`; ``dw_q / 2.0`` is exact either way."""
    x = delta.to(torch.float32)
    d = x.numel()
    lam = float(np.float32(lambda_))
    absx = torch.abs(x)
    inf = torch.amax(absx)
    safe_inf = torch.where(inf > 0, inf, torch.ones_like(inf))

    hi_mask = (absx / safe_inf) >= lam                  # eq. (6)
    dbar = torch.sum(hi_mask)
    # smallest high-resolution magnitude = grid anchor dw_q
    dw_q = torch.amin(torch.where(hi_mask, absx, torch.inf))
    dw_q = torch.where(torch.isfinite(dw_q), dw_q, torch.zeros_like(dw_q))
    r = inf - dw_q                                       # grid radius
    levels = 2 ** b - 1
    step = true_div(r, levels)
    safe_step = torch.where(step > 0, step, torch.ones_like(step))

    # high-resolution reconstruction: b-bit uniform grid on [dw_q, inf]
    code = torch.round((absx - dw_q) / safe_step)
    q_mag = dw_q + code * step
    hi_recon = torch.sign(x) * q_mag

    # low-resolution reconstruction: sign bit -> +- dw_q_hat / 2 (eq. 8)
    # sign convention per eq. (7): bit 1 <=> x > 0, bit 0 <=> x <= 0.
    lo_recon = torch.where(x > 0, dw_q / 2.0, -dw_q / 2.0)

    recon = torch.where(hi_mask, hi_recon, lo_recon)
    recon = torch.where(inf > 0, recon, torch.zeros_like(x))

    s = true_div(dbar.to(torch.float32), d)
    bits = d * (b * s + 1.0 - s) + _F32_BITS
    bits = torch.where(inf > 0, bits, torch.full_like(bits, d + _F32_BITS))
    aux = {"s": s, "dbar": dbar, "r": r, "dw_q": dw_q, "inf": inf}
    return QuantResult(recon=recon, bits=bits, aux=aux)


class MixedResolutionQuantizer(Quantizer):
    """Paper quantizer with per-user threshold lambda_ and bit width b."""

    name = "mixed-resolution"

    def __init__(self, lambda_: float = 0.2, b: int = 10):
        if not (0.0 <= lambda_ <= 1.0):
            raise ValueError(f"lambda_ must be in [0,1], got {lambda_}")
        if b < 2:
            raise ValueError(f"b must be >= 2, got {b}")
        self.lambda_ = float(lambda_)
        self.b = int(b)

    def __call__(self, delta, state: Any = None) -> Tuple[QuantResult, Any]:
        return mixed_resolution_quantize(delta, self.lambda_, self.b), state

    def error_bound(self) -> float:
        return lemma1_bound(self.lambda_, self.b)

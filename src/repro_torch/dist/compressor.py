"""The mixed-resolution aggregation identity of
``repro.dist.compressor``: a weighted sum of reconstructions routed
through the packed 1-bit sign plane (K4, K5) plus a dense correction.

Only what the sim engine's signplane plane runs is ported here.
``CompressorConfig``, ``aggregate_delta``, ``aggregate_flat_stacked``,
``aggregate_flat_manual``, the sharding and the distributed steps come
with the distributed runtime in a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import WirePath
from repro_torch.kernels.ops import packed_sign_weighted_sum


def _sign_scales(dw_q: torch.Tensor, G: int) -> torch.Tensor:
    """Per-peer sign-plane weights for the uniform mean: dw_q_g / (2G)."""
    return (dw_q * (0.5 / G)).to(torch.float32)


def lo_plane(flat: torch.Tensor, dw_q: torch.Tensor) -> torch.Tensor:
    """The low-resolution reconstruction plane ``sign(x) * dw_q/2``
    (sign(0) = -1, matching the packed sign-bit convention)."""
    half = dw_q[..., None] * 0.5
    return torch.where(flat > 0, half, -half)


def signplane_weighted_aggregate(flat: torch.Tensor, recons: torch.Tensor,
                                 dw_q: torch.Tensor, weights: torch.Tensor,
                                 *, path: Optional[WirePath] = None
                                 ) -> torch.Tensor:
    """``sum_g weights_g * recons_g`` through the packed wire format.

    The 1-bit plane reduces inside K4–K5 with per-peer scales
    ``w_g * dw_q_g / 2``; the high-resolution correction
    ``recons - lo_plane`` — nonzero only on each peer's high-resolution
    support — rides a dense weighted sum.  The JAX package's op order."""
    low = packed_sign_weighted_sum(
        flat, (weights * dw_q * 0.5).to(torch.float32), path=path)
    corr = torch.einsum("g,gd->d", weights, recons - lo_plane(flat, dw_q))
    return low + corr

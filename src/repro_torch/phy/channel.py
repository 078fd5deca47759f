"""Batched CFmMIMO channel layer (eq. 4-5) on torch tensors.

``ChannelBatch`` carries the eq. (5) coefficient bundle
(A_bar, B_bar, B_tilde, I_M) with any leading batch axes, as
``repro.phy.channel.ChannelBatch`` does.  Three ways to build one:

* :func:`bundle_from_realizations` — stack numpy
  ``ChannelRealization`` objects (exact, no re-derivation);
* :func:`compute_bundle` — the eq. (5) math in torch given
  (beta, pilot), over any leading batch axes;
* :func:`make_channel_batch` — B realizations whose geometry and
  (sequential, data-dependent) greedy pilot assignment are drawn on the
  host exactly as ``make_channel`` draws them, with the O(M K^2) bundle
  math batched on the device.

Every builder takes the bundle's ``dtype`` (float32 by default, what
the batched sweep driver solves in; float64 is the parity mode) and
``device`` (the card unless the caller asks for the CPU).  The numpy
layer in ``core/channel`` stays the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.channel.cfmmimo import (CFmMIMOConfig,
                                              ChannelRealization,
                                              _greedy_pilot_assignment,
                                              draw_positions,
                                              large_scale_fading)
from repro_torch.device import resolve_device

_FIELDS = ("A_bar", "B_bar", "B_tilde", "I_M")


@dataclasses.dataclass(frozen=True)
class ChannelBatch:
    """eq. (5) coefficient bundle with leading batch axes.  The scalar
    network constants are shared by the whole batch (one scenario, one
    Table I parameterization)."""
    A_bar: torch.Tensor       # [..., K]
    B_bar: torch.Tensor       # [..., K]
    B_tilde: torch.Tensor     # [..., K, K], zero diagonal
    I_M: torch.Tensor         # [..., K]
    pre_log: float            # B_tau = B (1 - tau_p / tau_c)
    p_max_w: float            # p^u

    @property
    def K(self) -> int:
        return self.A_bar.shape[-1]

    @property
    def batch_shape(self):
        return self.A_bar.shape[:-1]

    def sinr(self, p: torch.Tensor, mask: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """eq. (5): SINR per user for power vectors p [..., K].

        ``mask`` (0/1 per user) is the engine's sub-channel: inactive
        users neither transmit (p forced to 0, no interference) nor
        report a SINR (their entries are 0)."""
        if mask is not None:
            p = p * mask
        num = self.A_bar * p
        # B_tilde has a zero diagonal, so the matvec IS the j' != j sum
        cross = torch.matmul(self.B_tilde, p[..., None])[..., 0]
        den = self.B_bar * p + cross + self.I_M
        out = num / den
        if mask is not None:
            out = out * mask
        return out

    def rates(self, p: torch.Tensor, mask: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """eq. (4): achievable uplink rate (bit/s) per user."""
        return self.pre_log * torch.log2(1.0 + self.sinr(p, mask))


def bundle_from_realizations(chans: Sequence[ChannelRealization],
                             dtype: torch.dtype = torch.float32,
                             device=None) -> ChannelBatch:
    """Stack numpy realizations into one [B, ...] bundle on ``device``."""
    if not chans:
        raise ValueError("need at least one realization")
    cfg = chans[0].cfg
    for c in chans[1:]:
        if (c.cfg.pre_log != cfg.pre_log
                or c.cfg.p_max_w != cfg.p_max_w or c.cfg.K != cfg.K):
            raise ValueError("realizations in a batch must share the "
                             "network constants (pre_log, p_max, K)")
    dev = resolve_device(device)
    stack = {f: torch.as_tensor(np.stack([getattr(c, f) for c in chans]),
                                dtype=dtype, device=dev) for f in _FIELDS}
    return ChannelBatch(pre_log=cfg.pre_log, p_max_w=cfg.p_max_w, **stack)


def bundle_from_realization_grid(
        grid: Sequence[Sequence[ChannelRealization]],
        dtype: torch.dtype = torch.float32, device=None) -> ChannelBatch:
    """Stack a [cells][R] grid of realizations into one flat [cells * R]
    bundle, cell-major: row ``i * R + r`` is (cell i, replicate r)."""
    return bundle_from_realizations([chan for row in grid for chan in row],
                                    dtype=dtype, device=device)


def compute_bundle(cfg: CFmMIMOConfig, beta: torch.Tensor,
                   pilot: torch.Tensor) -> ChannelBatch:
    """eq. (5) bundle from (beta [..., M, K], pilot [..., K]) in beta's
    dtype and on its device; ``make_channel``'s numpy math op for op
    (the squared coherent-gain numerator included)."""
    copilot = (pilot[..., :, None] == pilot[..., None, :]).to(beta.dtype)
    sigma2 = cfg.noise_w
    p_p = cfg.tau_p * cfg.p_max_w

    denom = p_p * torch.einsum("...mj,...jk->...mk", beta, copilot) + sigma2
    gamma = p_p * beta ** 2 / denom                       # [..., M, K]

    N = float(cfg.N)
    A_bar = (N * gamma.sum(dim=-2)) ** 2                  # [..., K]
    B_bar = N * (gamma * beta).sum(dim=-2)
    I_M = N * sigma2 * gamma.sum(dim=-2) / cfg.p_max_w

    first = N * torch.einsum("...mj,...mk->...jk", gamma, beta)
    ratio = N * torch.einsum("...mj,...mj,...mk->...jk",
                             gamma, 1.0 / beta, beta)
    B_tilde = first + copilot * ratio ** 2
    K = beta.shape[-1]
    eye = torch.eye(K, dtype=beta.dtype, device=beta.device)
    B_tilde = B_tilde * (1.0 - eye)                       # j' != j sum only
    return ChannelBatch(A_bar=A_bar, B_bar=B_bar, B_tilde=B_tilde,
                        I_M=I_M, pre_log=cfg.pre_log, p_max_w=cfg.p_max_w)


def make_channel_batch(cfg: CFmMIMOConfig, seeds: Sequence[int],
                       dtype: torch.dtype = torch.float32,
                       device=None) -> ChannelBatch:
    """B large-scale realizations as one bundle: per seed
    ``make_channel``'s geometry and pilot assignment on the host (same
    RNG stream, same greedy loop), then one batched
    :func:`compute_bundle` on ``device``."""
    betas, pilots = [], []
    for seed in seeds:
        ap, users = draw_positions(cfg, int(seed))
        beta = large_scale_fading(cfg, ap, users)
        betas.append(beta)
        pilots.append(_greedy_pilot_assignment(beta, cfg.tau_p))
    dev = resolve_device(device)
    return compute_bundle(
        cfg, torch.as_tensor(np.stack(betas), dtype=dtype, device=dev),
        torch.as_tensor(np.stack(pilots), device=dev))


def uplink_latency_batch(bits: torch.Tensor, rates: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """eq. (12) batched; masked (absent) users contribute 0 latency, so
    they never become the straggler."""
    lat = bits / torch.clamp_min(rates, 1e-9)
    return lat if mask is None else lat * mask


__all__ = ["ChannelBatch", "bundle_from_realization_grid",
           "bundle_from_realizations", "compute_bundle",
           "make_channel_batch", "uplink_latency_batch"]

"""LAQ — Lazily Aggregated Quantized Gradients [Sun et al., TPAMI 2022].

Each user quantizes the *innovation* of its local gradient relative to
the most recently transmitted quantized gradient, with b-bit uniform
quantization on a grid of radius ``||innovation||_inf``.  A user skips
the upload (0 payload bits; the server reuses its last transmitted
value) when the innovation energy is at most ``xi`` times the mean of
its D recent update energies.

State per user: (last transmitted quantized vector, D recent update
energies, ring pointer).  Op for op ``repro.core.quantize.laq``; the
ring write is a ``torch.where`` over the D slots, which stays correct
under ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import true_div

from .base import QuantResult, Quantizer


class LAQState(NamedTuple):
    last_sent: torch.Tensor    # last transmitted quantized vector
    energies: torch.Tensor     # ring buffer of D recent update energies
    ptr: torch.Tensor          # ring pointer (int32)


def _uniform_quantize(x: torch.Tensor, b: int) -> torch.Tensor:
    """b-bit uniform quantization on [-r, r], r = ||x||_inf.  Each
    element is a function of itself and ``r`` alone (IEEE divisions on
    every device), so the result is bit for bit the JAX package's."""
    r = torch.amax(torch.abs(x))
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    levels = 2 ** (b - 1) - 1          # symmetric grid incl. sign
    step = true_div(safe_r, levels)
    q = torch.round(x / step) * step
    return torch.where(r > 0, q, torch.zeros_like(x))


def laq_quantize(delta: torch.Tensor, state: LAQState, b: int, xi: float
                 ) -> Tuple[QuantResult, LAQState]:
    """One user's LAQ step.  ``xi`` is rounded to float32 before the
    skip test, as JAX does implicitly."""
    x = delta.to(torch.float32)
    d = x.numel()
    innovation = x - state.last_sent
    q_innov = _uniform_quantize(innovation, b)
    candidate = state.last_sent + q_innov
    energy = torch.sum(q_innov ** 2)

    hist = torch.mean(state.energies)
    # lazy rule: skip when the innovation energy is below xi * history.
    # First rounds (hist == 0) always transmit.
    skip = (hist > 0) & (energy <= float(np.float32(xi)) * hist)

    recon = torch.where(skip, state.last_sent, candidate)
    bits = torch.where(skip, torch.zeros_like(energy),
                       torch.full_like(energy, float(d) * b + 32.0))

    D = state.energies.shape[0]
    slot = torch.arange(D, device=x.device) == state.ptr
    new_energies = torch.where(slot & ~skip, energy, state.energies)
    new_ptr = torch.where(skip, state.ptr, (state.ptr + 1) % D)
    new_state = LAQState(last_sent=recon, energies=new_energies, ptr=new_ptr)
    aux = {"s": torch.ones_like(energy), "skipped": skip, "energy": energy}
    return QuantResult(recon=recon, bits=bits, aux=aux), new_state


class LAQQuantizer(Quantizer):
    name = "laq"

    def __init__(self, b: int = 4, xi: float = 0.8, history: int = 10):
        self.b = int(b)
        self.xi = float(xi)
        self.history = int(history)

    def init_state(self, dim: int, device=None) -> LAQState:
        return LAQState(
            last_sent=torch.zeros(dim, dtype=torch.float32, device=device),
            energies=torch.zeros(self.history, dtype=torch.float32,
                                 device=device),
            ptr=torch.zeros((), dtype=torch.int32, device=device))

    def __call__(self, delta, state: Any = None) -> Tuple[QuantResult, Any]:
        if state is None:
            state = self.init_state(delta.numel(), device=delta.device)
        return laq_quantize(delta, state, self.b, self.xi)

"""Algorithm 1 — FL over CFmMIMO with adaptive mixed-resolution
quantization and straggler-mitigating power control.

Per global round t:
  1. users run L local AdaGrad iterations from w_{t-1} (eq. 2);
  2. each quantizes its delta (eq. 7) and reports its bit count b_t^j;
  3. the server solves the power-control problem (eq. 14) for p_t;
  4. per-user uplink latency ell_t^j = b_t^j / R_t^j (eq. 12); the
     round costs max_j ell_t^j + computation time;
  5. server updates w_t = w_{t-1} + sum_j rho_j recon_j (eq. 3).

The run itself lives in :class:`repro_torch.sim.engine.VectorizedFLEngine`;
the one-user-at-a-time sequential loop of the JAX package is not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch
from torch.func import grad

from repro_torch.core.channel import ChannelRealization
from repro_torch.core.power.base import PowerController
from repro_torch.core.quantize import Quantizer
from repro_torch.data.federated import validate_shards
from repro_torch.data.synthetic import ImageDataset

from .cnn import cnn_loss


@dataclasses.dataclass
class FLConfig:
    L: int = 5                    # local AdaGrad iterations
    T: int = 100                  # global rounds
    batch_size: int = 64          # xi_j
    alpha: float = 0.03           # AdaGrad step size
    eps_a: float = 1e-8
    eval_every: int = 5
    latency_budget_s: Optional[float] = None   # stop when exceeded
    seed: int = 0
    dataset_size_for_comp: int = 50_000        # ell_c inputs [27]


@dataclasses.dataclass
class RoundLog:
    round: int
    bits_per_user: np.ndarray
    uplink_latency_s: float
    comp_latency_s: float
    cum_latency_s: float
    mean_s: float                 # mean high-res fraction (aux)
    test_acc: Optional[float]
    straggler_gap_s: float = 0.0          # slowest - median completion
    mean_staleness: float = 0.0
    effective_participation: float = 1.0
    dropped_uploads: int = 0
    quarantined_users: int = 0
    power_fallbacks: int = 0


@dataclasses.dataclass
class FLResult:
    params: Any
    logs: List[RoundLog]
    rounds_completed: int         # T_max under the budget

    @property
    def final_acc(self) -> float:
        accs = [l.test_acc for l in self.logs if l.test_acc is not None]
        return accs[-1] if accs else float("nan")

    def mean_bits(self) -> float:
        return float(np.mean([np.mean(l.bits_per_user) for l in self.logs]))

    def mean_s(self) -> float:
        return float(np.mean([l.mean_s for l in self.logs]))


def local_adagrad(params, xs, ys, L: int, alpha: float, loss=cnn_loss):
    """L AdaGrad steps on stacked minibatches xs [L,b,...], ys [L,b].

    A pure function of its inputs (gradients through ``torch.func``),
    so the engine runs every user's L steps at once under
    ``torch.func.vmap``.  Same update, in the same op order, as
    ``repro.fl.loop.local_adagrad``."""
    w = params
    g = {k: torch.zeros_like(v) for k, v in params.items()}
    dloss = grad(loss)
    for l in range(L):
        d = dloss(w, xs[l], ys[l])
        g = {k: g[k] + d[k] * d[k] for k in g}
        # alpha / sqrt(...) as one IEEE division: torch's scalar / tensor
        # is a reciprocal times the scalar, two roundings
        w = {k: w[k] - torch.full_like(g[k], alpha) / torch.sqrt(g[k] + 1e-8)
             * d[k] for k in w}
    return w


def run_fl(dataset: ImageDataset, test: ImageDataset,
           shards: List[np.ndarray], model,
           quantizer: Quantizer, power: Optional[PowerController],
           chan: Optional[ChannelRealization], fl: FLConfig,
           verbose: bool = False, engine: Optional[Any] = None,
           device=None, init_params=None) -> FLResult:
    """Algorithm 1 on :class:`VectorizedFLEngine` (``engine`` is its
    :class:`EngineConfig`).  Shards smaller than ``batch_size`` need the
    JAX package's sequential per-user loop, which is not ported."""
    from repro_torch.sim.engine import EngineConfig, VectorizedFLEngine

    validate_shards(shards)
    if min(len(s) for s in shards) < fl.batch_size:
        raise NotImplementedError(
            "a shard smaller than batch_size needs the sequential "
            "per-user loop, which is not ported to repro_torch yet")
    eng = VectorizedFLEngine(dataset, test, shards, model, quantizer,
                             power, chan, fl,
                             engine=engine or EngineConfig(),
                             device=device, init_params=init_params)
    return eng.run(verbose=verbose)

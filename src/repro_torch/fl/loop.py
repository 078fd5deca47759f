"""Algorithm 1 — FL over CFmMIMO with adaptive mixed-resolution
quantization and straggler-mitigating power control.

Per global round t:
  1. users run L local AdaGrad iterations from w_{t-1} (eq. 2);
  2. each quantizes its delta (eq. 7) and reports its bit count b_t^j;
  3. the server solves the power-control problem (eq. 14) for p_t;
  4. per-user uplink latency ell_t^j = b_t^j / R_t^j (eq. 12); the
     round costs max_j ell_t^j + computation time;
  5. server updates w_t = w_{t-1} + sum_j rho_j recon_j (eq. 3).

:func:`run_fl` runs :class:`repro_torch.sim.engine.VectorizedFLEngine`
(the exact mode unless ``engine`` says otherwise);
:func:`run_fl_sequential` is the one-user-at-a-time reference loop the
exact mode reproduces bit for bit, and what :func:`run_fl` falls back
to when a shard is smaller than ``batch_size``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch
from torch.func import grad
from torch.utils._pytree import tree_map

from repro_torch.core.channel import ChannelRealization, computation_latency
from repro_torch.core.power.base import PowerController
from repro_torch.core.quantize import Quantizer
from repro_torch.core.quantize.base import flatten_pytree, unflatten_pytree
from repro_torch.data.federated import user_fractions, validate_shards
from repro_torch.data.synthetic import ImageDataset
from repro_torch.device import resolve_device

from .cnn import cnn_loss
from .models import as_model_spec


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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the calls inside, and the
    previous flags back after.  On the card the default weight-gradient
    algorithms are not: two identical per-user calls of the paper CNN at
    full width give other bits (``tools/probe_exact_mode.py``).  Only
    ``deterministic`` and ``benchmark`` are set: ``cudnn.flags()`` would
    also reset ``enabled``, ``allow_tf32`` and the fp32 precision to its
    own defaults.  No effect on the CPU."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


def local_delta(params, xs, ys, L: int, alpha: float, loss=cnn_loss
                ) -> torch.Tensor:
    """One user's L local AdaGrad steps -> its flat delta ``[d]`` in
    :func:`flatten_pytree`'s leaf order.  The one per-user call of both
    :func:`run_fl_sequential` and the engine's exact mode, so the two
    train alike bit for bit (``vmap`` over users batches the conv
    backward another way, see ``tests/test_torch_exact.py``); both make
    it inside :func:`deterministic_cudnn`."""
    w = local_adagrad(params, xs, ys, L, alpha, loss)
    return flatten_pytree({k: w[k] - params[k] for k in params})[0]


def run_fl(dataset: ImageDataset, test: ImageDataset,
           shards: List[np.ndarray], model,
           quantizer: Quantizer, power: Optional[PowerController],
           chan: Optional[ChannelRealization], fl: FLConfig,
           verbose: bool = False, engine: Optional[Any] = None,
           device=None, init_params=None) -> FLResult:
    """Algorithm 1 on :class:`VectorizedFLEngine` (``engine`` is its
    :class:`EngineConfig`; the default runs the exact mode, bit for bit
    :func:`run_fl_sequential`).  When some shard is smaller than
    ``batch_size`` the engine's uniform ``[K, L, b]`` stacking cannot
    replay the per-user ``min(batch_size, |D_j|)``, so this falls back
    to :func:`run_fl_sequential` (ignoring ``engine``), as the JAX
    package does.  power/chan None => latency not simulated."""
    from repro_torch.sim.engine import VectorizedFLEngine

    validate_shards(shards)
    if min(len(s) for s in shards) < fl.batch_size:
        return run_fl_sequential(dataset, test, shards, model, quantizer,
                                 power, chan, fl, verbose=verbose,
                                 device=device, init_params=init_params)
    eng = VectorizedFLEngine(dataset, test, shards, model, quantizer,
                             power, chan, fl, engine=engine,
                             device=device, init_params=init_params)
    return eng.run(verbose=verbose)


def run_fl_sequential(dataset: ImageDataset, test: ImageDataset,
                      shards: List[np.ndarray], model,
                      quantizer: Quantizer, power: Optional[PowerController],
                      chan: Optional[ChannelRealization], fl: FLConfig,
                      verbose: bool = False, device=None,
                      init_params=None) -> FLResult:
    """Algorithm 1, one user at a time — ``repro.fl.run_fl_sequential``.

    The numerical reference of the engine's exact mode: per round each
    user in turn draws its ``min(batch_size, |D_j|)`` minibatches from
    the run's one numpy stream, trains (:func:`local_delta`) and is
    quantized by the per-user ``quantizer`` call; the update is
    Python's ``sum`` of ``recon_j * rho_j`` (each weight rounded once
    to f32), starting at 0.  ``device`` defaults to the card;
    ``init_params`` replaces the model's own init (JAX's PRNG init is
    not reproducible here: carry it with ``params_from_jax``)."""
    spec_m = as_model_spec(model)
    validate_shards(shards)
    dev = resolve_device(device)
    K = len(shards)
    rho = user_fractions(shards)
    w32 = torch.tensor(rho, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(fl.seed)
    if init_params is None:
        init_params = spec_m.init(torch.Generator().manual_seed(fl.seed))
    params = {k: v.detach().to(dev, torch.float32)
              for k, v in init_params.items()}
    flat0, spec = flatten_pytree(params)
    d = int(flat0.numel())
    state0 = quantizer.init_state(d)
    qstates = [None if state0 is None
               else tree_map(lambda x: x.to(dev, copy=True), state0)
               for _ in range(K)]
    test_x = torch.as_tensor(test.x, device=dev)
    test_y = torch.as_tensor(test.y, device=dev)

    comp_lat = computation_latency(fl.L, fl.dataset_size_for_comp, K)
    logs: List[RoundLog] = []
    cum_latency = 0.0
    rounds_done = 0

    for t in range(1, fl.T + 1):
        recons = []
        bits = np.zeros(K)
        s_fracs = []
        with torch.no_grad(), deterministic_cudnn():
            for j in range(K):
                shard = shards[j]
                take = min(fl.batch_size, len(shard))
                sel = np.stack([rng.choice(shard, take, replace=False)
                                for _ in range(fl.L)])
                xs = torch.as_tensor(dataset.x[sel], device=dev)
                ys = torch.as_tensor(dataset.y[sel], device=dev)
                flat = local_delta(params, xs, ys, fl.L, fl.alpha,
                                   spec_m.loss)
                res, qstates[j] = quantizer(flat, qstates[j])
                recons.append(res.recon)
                bits[j] = float(res.bits)
                s_fracs.append(float(res.aux.get("s", 1.0)))

            # eq. (3): weighted aggregation of reconstructions
            agg = sum(r * w32[j] for j, r in enumerate(recons))
            upd = unflatten_pytree(agg, spec)
            params = {k: params[k] + upd[k] for k in params}

        # power control + latency accounting
        if power is not None and chan is not None:
            sol = power.solve(chan, np.maximum(bits, 1.0))
            uplink = sol.straggler_latency
        else:
            uplink = 0.0
        cum_latency += uplink + comp_lat

        acc = None
        if t % fl.eval_every == 0 or t == fl.T:
            acc = spec_m.accuracy(params, test_x, test_y)
        logs.append(RoundLog(t, bits, uplink, comp_lat, cum_latency,
                             float(np.mean(s_fracs)), acc))
        rounds_done = t
        if verbose and acc is not None:
            print(f"[round {t:4d}] acc={acc:.4f} "
                  f"bits/user={bits.mean():.3e} cum_lat={cum_latency:.2f}s")
        if (fl.latency_budget_s is not None
                and cum_latency >= fl.latency_budget_s):
            break

    return FLResult(params=params, logs=logs, rounds_completed=rounds_done)

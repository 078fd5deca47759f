"""Vectorized FL-over-CFmMIMO engine — the port of
``repro.sim.engine.VectorizedFLEngine``'s single-trajectory modes.

Execution modes (:class:`EngineConfig`):

* exact (``fused=False``, the default — what :func:`repro_torch.fl.run_fl`
  runs): each user's L local AdaGrad steps run through the same
  per-user call as :func:`repro_torch.fl.run_fl_sequential`
  (``local_delta``), then one batched quantize of the stacked ``[K, d]``
  deltas and the sequential loop's left-to-right fold ``agg = term``,
  ``agg + term`` of ``recon_j * w_j``.  Bit for bit
  ``run_fl_sequential`` on the same device.  ``torch.func.vmap`` over
  users would batch the conv backward another way and is not bit for
  bit the per-user call (``tests/test_torch_exact.py``);
* fused (``fused=True``, or a packed or signplane plane — what the
  scenario sweeps run): the users' local runs as one ``vmap`` (cuDNN /
  cuBLAS on the card), then one rho-weighted update
  (:meth:`VectorizedFLEngine.aggregate`) by wire plane:

  * ``"packed"`` — encoded to packed planes (K1, the scalar epilogue,
    K2) and decoded into the update (K3), no dense reconstruction;
  * ``"signplane"`` — quantized per user (``Quantizer.batched``), the
    sign plane reduced through K4–K5 plus a dense correction
    (``repro_torch.dist.signplane_weighted_aggregate``);
  * ``"dense"`` — quantized per user by any quantizer and reduced by
    one weighted sum;

  the packed and signplane planes carry the mixed-resolution wire
  format and refuse every other quantizer.

In both modes a stateful quantizer (LAQ) carries its stacked per-user
state from round to round (``RunState.qstate``), and the host solves
power control and accounts latency (:meth:`solve_uplink_host`,
:meth:`finish_round`).  Beyond the paper's fixed setting the engine
simulates user churn (``participation < 1``: each round a fresh
never-empty active set, weights ``rho * active`` renormalized, absent
users' quantizer state frozen, their bits 0, and the power solved on
the active users' sub-channel; the wire kernels still encode every
user and fold the absent ones at weight 0) and Monte-Carlo channel
redraws (a fresh realization every ``redraw_channel_every`` rounds).

The Monte-Carlo replicate axis (:meth:`start_replicated_run`,
:meth:`train_round_replicated`) runs R independent trajectories of one
fused problem: per replicate its own minibatch and churn streams and
its own channel realizations, params and quantizer state stacked on a
leading R axis, one step call a round (``torch.func.vmap`` over R, or a
loop over the replicates; :attr:`EngineConfig.replicate_batching`).
The batched sweep driver (``sim/phy_driver.py``) owns the latency
accounting per (cell, replicate).

Modes of the JAX engine that are not ported raise
:class:`NotImplementedError`: cohorts, clusters, budgets and the
checksum (all on :class:`WirePath`), async rounds, the mesh and
resilience.  The port has no observability taps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from repro_torch.core.channel import (ChannelRealization, computation_latency,
                                      make_channel)
from repro_torch.core.power.base import PowerController
from repro_torch.core.quantize import Quantizer
from repro_torch.core.quantize.base import flatten_pytree, unflatten_pytree
from repro_torch.data.federated import user_fractions, validate_shards
from repro_torch.data.synthetic import ImageDataset
from repro_torch.device import resolve_device
from repro_torch.dist.compressor import signplane_weighted_aggregate
from repro_torch.kernels import WirePath, check_packed_dim
from repro_torch.kernels.ops import mixed_res_wire_aggregate


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs, as ``repro.sim.EngineConfig``: the exact mode by
    default (``fused=False``), the wire plane in ``wire.plane``, churn
    (``participation``) and channel redraws (``redraw_channel_every``
    from ``channel_seed``).  The knobs of a mode not ported raise
    :class:`NotImplementedError`."""
    # the dense plane unless set, as JAX's EngineConfig() resolves its
    # default aggregation="dense"
    wire: WirePath = dataclasses.field(
        default_factory=lambda: WirePath(plane="dense"))
    fused: bool = False
    participation: float = 1.0       # P(user active in a round) — churn
    redraw_channel_every: int = 0    # 0 = fixed realization (paper)
    channel_seed: int = 0            # base seed for Monte-Carlo redraws
    # how the replicate axis R runs the fused step: "vmap" batches all R
    # trajectories in one torch.func.vmap, "map" loops the replicates;
    # "auto" picks "vmap" on the card and "map" on the CPU.  The packed
    # and signplane planes always "map": the kernels take one
    # replicate's [K, d] at a time and have no vmap rule.
    replicate_batching: str = "auto"  # "auto" | "map" | "vmap"
    async_mode: bool = False
    mesh: Optional[object] = None
    resilience: Optional[object] = None

    def __post_init__(self):
        unported = {"async_mode": (self.async_mode, False),
                    "mesh": (self.mesh, None),
                    "resilience": (self.resilience, None)}
        for name, (value, off) in unported.items():
            if value != off:
                raise NotImplementedError(
                    f"EngineConfig.{name}={value!r} is not ported to "
                    "repro_torch yet")

    @property
    def effective_fused(self) -> bool:
        """The packed and signplane planes run only fused."""
        return self.fused or self.wire.plane != "dense"


class UplinkSolution(NamedTuple):
    """Structured result of the uplink power solve (stage 3)."""
    straggler_s: float
    latencies: np.ndarray


@dataclasses.dataclass
class RoundWork:
    """What one training round hands to the power-control stage."""
    t: int
    bits_np: np.ndarray            # [K] payload bits; 0 for absent users
    active: np.ndarray             # [K] 0/1 participation mask
    mean_s: float                  # mean high-res fraction (active users)


@dataclasses.dataclass
class ReplicatedRoundWork:
    """RoundWork with a leading Monte-Carlo replicate axis R."""
    t: int
    bits_np: np.ndarray            # [R, K] payload bits; 0 for absent users
    active: np.ndarray             # [R, K] 0/1 participation masks
    mean_s: np.ndarray             # [R] mean high-res fraction per replicate


@dataclasses.dataclass
class RunState:
    """Mutable per-run state for the round-stepping API."""
    params: dict
    chan: Optional[ChannelRealization]
    rng: np.random.Generator
    part_rng: np.random.Generator  # the churn stream
    test_x: torch.Tensor
    test_y: torch.Tensor
    logs: List
    qstate: Any = None             # stacked quantizer state (or None)
    cum_latency: float = 0.0
    rounds_done: int = 0


@dataclasses.dataclass
class ReplicatedRunState:
    """Per-run state of R Monte-Carlo replicates: params and quantizer
    state stacked on a leading R axis (each replicate in storage of its
    own), per-replicate RNG streams and channel realizations.  Latency
    accounting is the batched driver's, per (cell, replicate)."""
    params: dict                               # [R, ...] per leaf
    qstate: Any                                # [R, K, ...] (or None)
    chans: List[Optional[ChannelRealization]]  # length R
    rngs: List[np.random.Generator]            # minibatch streams
    part_rngs: List[np.random.Generator]       # churn streams
    test_x: torch.Tensor
    test_y: torch.Tensor
    rounds_done: int = 0

    @property
    def R(self) -> int:
        return len(self.rngs)


# RNG streams of replicate r > 0 (replicate 0 keeps the unreplicated
# streams, so R = 1 is the unreplicated run):
# minibatches   default_rng((seed, _REPL_TAG, r))
# churn         default_rng((seed, 0x5EED, _REPL_TAG, r))
# channels      make_channel(seed = channel_seed + r * stride + t)
# The stride keeps the replicates' channel seeds apart from the
# unreplicated redraw seeds (channel_seed + t, t <= T << stride).
_REPL_TAG = 0x4D43                  # "MC"
_REPL_CHANNEL_SEED_STRIDE = 1 << 20


def _subchannel(chan: ChannelRealization, idx: np.ndarray
                ) -> ChannelRealization:
    """Restrict a realization to the active-user subset: inactive users
    neither transmit (no power allocated, no interference) nor count
    toward the straggler latency."""
    cfg = dataclasses.replace(chan.cfg, K=len(idx))
    return dataclasses.replace(
        chan, cfg=cfg, beta=chan.beta[:, idx], pilot=chan.pilot[idx],
        gamma=chan.gamma[:, idx], A_bar=chan.A_bar[idx],
        B_bar=chan.B_bar[idx], B_tilde=chan.B_tilde[np.ix_(idx, idx)],
        I_M=chan.I_M[idx])


def _each(fn, tree):
    """``tree_map`` that leaves None (no quantizer state, no churn mask)
    as None."""
    return None if tree is None else tree_map(fn, tree)


def ordered_weighted_sum(recon: torch.Tensor, weights: torch.Tensor
                         ) -> torch.Tensor:
    """``sum_j recon_j * weights_j`` folded left to right, ``agg =
    term`` then ``agg + term``: one IEEE rounding a product and a sum,
    the same bits on the CPU and on the card (the exact mode's fold)."""
    agg = None
    for j in range(recon.shape[0]):
        term = recon[j] * weights[j]
        agg = term if agg is None else agg + term
    return agg


def straggler_gap(per_user_s: np.ndarray, mask: np.ndarray) -> float:
    """Slowest-minus-median upload completion time over ``mask`` users."""
    lat = np.asarray(per_user_s, np.float64)[np.asarray(mask) > 0]
    if lat.size == 0:
        return 0.0
    return float(np.max(lat) - np.median(lat))


class VectorizedFLEngine:
    """Algorithm 1 over K users a round: the exact mode trains them one
    by one, the fused mode in one ``vmap`` step (see the module
    docstring).

    ``device`` defaults to the card (``repro_torch.device``);
    ``init_params`` (a params dict, e.g. from
    :func:`repro_torch.fl.cnn.params_from_jax`) replaces the model's own
    init, so a run can start from the JAX package's weights."""

    def __init__(self, dataset: ImageDataset, test: ImageDataset,
                 shards: List[np.ndarray], model,
                 quantizer: Quantizer, power: Optional[PowerController],
                 chan: Optional[ChannelRealization], fl,
                 engine: Optional[EngineConfig] = None, *,
                 device=None, init_params=None):
        from repro_torch.fl.models import as_model_spec

        self.device = resolve_device(device)
        self.model_spec = as_model_spec(model)
        self.engine_cfg = engine or EngineConfig()
        if self.engine_cfg.replicate_batching not in ("auto", "map",
                                                      "vmap"):
            raise ValueError(f"unknown replicate_batching "
                             f"{self.engine_cfg.replicate_batching!r}")
        self.wire_path_spec = self.engine_cfg.wire
        plane = self.wire_path_spec.plane
        if (plane in ("signplane", "packed")
                and quantizer.name != "mixed-resolution"):
            raise ValueError(
                f"the {plane} wire plane packs the mixed-resolution "
                f"wire format; quantizer {quantizer.name!r} has none")
        if plane == "packed" and quantizer.b > 16:
            raise ValueError(
                "the wire kernels store magnitude codes in <= 16 bits; "
                f"got b={quantizer.b}")
        self.dataset, self.test = dataset, test
        self.shards = shards
        self.quantizer, self.power, self.chan, self.fl = \
            quantizer, power, chan, fl
        self.K = len(shards)
        validate_shards(shards)
        # uniform minibatch size so user batches stack to [K, L, b]
        self.take = min(fl.batch_size, min(len(s) for s in shards))
        self.rho = user_fractions(shards)
        self._weights = torch.tensor(self.rho, dtype=torch.float32,
                                     device=self.device)

        if init_params is None:
            gen = torch.Generator().manual_seed(fl.seed)
            init_params = self.model_spec.init(gen)
        self.params = {k: v.detach().to(self.device, torch.float32)
                       for k, v in init_params.items()}
        flat0, self.spec = flatten_pytree(self.params)
        self.d = int(flat0.numel())
        if plane == "packed":
            check_packed_dim(self.d, where="the packed wire plane")
        self.qstate = quantizer.init_batched_state(self.K, self.d,
                                                   device=self.device)
        self.comp_lat = computation_latency(fl.L, fl.dataset_size_for_comp,
                                            self.K)
        # the datasets live on the device for the whole run; each round
        # gathers its minibatches there from host-drawn indices
        self._train_x = torch.as_tensor(dataset.x, device=self.device)
        self._train_y = torch.as_tensor(dataset.y, device=self.device)

    # ------------------------------------------------------------ step
    def _batched_local(self, params, xs, ys) -> torch.Tensor:
        """All stacked users' local AdaGrad runs -> [K, d] deltas, in
        ``flatten_pytree``'s leaf order: one ``vmap`` over the users
        (the fused mode)."""
        from repro_torch.fl.loop import local_adagrad

        fl, loss = self.fl, self.model_spec.loss
        local = vmap(lambda x, y: local_adagrad(params, x, y, fl.L,
                                                fl.alpha, loss))(xs, ys)
        K = xs.shape[0]
        return torch.cat([(local[k] - params[k]).reshape(K, -1)
                          for k in sorted(params)], dim=1)

    def _per_user_local(self, params, xs, ys) -> torch.Tensor:
        """The exact mode's local runs -> [K, d] deltas: each user
        through ``local_delta``, the sequential loop's own call, with
        cuDNN's deterministic algorithms (``deterministic_cudnn``)."""
        from repro_torch.fl.loop import deterministic_cudnn, local_delta

        fl, loss = self.fl, self.model_spec.loss
        with deterministic_cudnn():
            return torch.stack([local_delta(params, xs[j], ys[j], fl.L,
                                            fl.alpha, loss)
                                for j in range(xs.shape[0])])

    def _freeze_absent(self, new, old, active: Optional[torch.Tensor]):
        """Absent users did not transmit: their quantizer state stays
        ``old``.  ``active`` None means every user took part."""
        if new is None or active is None:
            return new
        return tree_map(
            lambda n, o: torch.where(
                active.reshape((self.K,) + (1,) * (n.dim() - 1)) > 0, n, o),
            new, old)

    def aggregate(self, flat: torch.Tensor, qstate: Any = None,
                  weights: Optional[torch.Tensor] = None,
                  active: Optional[torch.Tensor] = None):
        """Stacked ``[K, d]`` deltas and the quantizer's stacked state ->
        ``(agg [d], bits [K], aux, new qstate)``, the weighted update on
        this engine's wire plane (the fused mode).  ``weights`` (f32
        ``[K]``) default to rho; under churn an ``active`` mask freezes
        absent users' state."""
        q, path = self.quantizer, self.wire_path_spec
        w = self._weights if weights is None else weights
        if path.plane == "packed":
            agg, bits, aux = mixed_res_wire_aggregate(flat, w, q.lambda_,
                                                      q.b, path=path)
            return agg, bits, aux, qstate
        res, new_qstate = q.batched(flat, qstate)
        new_qstate = self._freeze_absent(new_qstate, qstate, active)
        if path.plane == "signplane":
            agg = signplane_weighted_aggregate(
                flat, res.recon, res.aux["dw_q"], w, path=path)
        else:
            agg = torch.einsum("k,kd->d", w, res.recon)
        return agg, res.bits, res.aux, new_qstate

    def _fused_step(self, params, qstate, xs, ys, weights=None,
                    active=None):
        flat = self._batched_local(params, xs, ys)
        agg, bits, aux, qstate = self.aggregate(flat, qstate, weights,
                                                active)
        upd = unflatten_pytree(agg, self.spec)
        return {k: params[k] + upd[k] for k in params}, qstate, bits, aux

    def _exact_step(self, params, qstate, xs, ys, weights, active=None):
        """The exact mode's round (``repro.sim.engine._dense_round``):
        per-user training, one batched quantize, then the sequential
        loop's left-to-right sum of ``recon_j * w_j`` (``weights`` f32
        ``[K]``, each rounded once from float64) and the update."""
        flat = self._per_user_local(params, xs, ys)
        res, new_qstate = self.quantizer.batched(flat, qstate)
        qstate = self._freeze_absent(new_qstate, qstate, active)
        upd = unflatten_pytree(ordered_weighted_sum(res.recon, weights),
                               self.spec)
        return {k: params[k] + upd[k] for k in params}, qstate, \
            res.bits, res.aux

    # ----------------------------------------------- round-stepping API
    def start_run(self) -> RunState:
        """A fresh run: private copies of the initial params and
        quantizer state, so a reused engine starts every run alike."""
        return RunState(
            params={k: v.clone() for k, v in self.params.items()},
            qstate=None if self.qstate is None
            else tree_map(torch.clone, self.qstate),
            chan=self.chan,
            rng=np.random.default_rng(self.fl.seed),
            part_rng=np.random.default_rng((self.fl.seed, 0x5EED)),
            test_x=torch.as_tensor(self.test.x, device=self.device),
            test_y=torch.as_tensor(self.test.y, device=self.device),
            logs=[])

    def draw_minibatches(self, state: RunState):
        """The round's [K, L, b, ...] minibatches from ``state.rng``, in
        the JAX engine's nested draw order, gathered on the device."""
        sel = np.stack([
            np.stack([state.rng.choice(shard, self.take, replace=False)
                      for _ in range(self.fl.L)])
            for shard in self.shards])               # [K, L, b]
        idx = torch.as_tensor(sel, device=self.device)
        return self._train_x[idx], self._train_y[idx]

    def _draw_active(self, part_rng: np.random.Generator) -> np.ndarray:
        """The round's 0/1 participation mask; never an empty round."""
        p = self.engine_cfg.participation
        if p >= 1.0:
            return np.ones(self.K)
        mask = part_rng.random(self.K) < p
        if not mask.any():
            mask[int(part_rng.integers(self.K))] = True
        return mask.astype(np.float64)

    def _round_weights(self, active: np.ndarray) -> np.ndarray:
        """float64 ``rho * active`` renormalized (exactly rho without
        churn)."""
        if self.engine_cfg.participation >= 1.0:
            return self.rho
        w = self.rho * active
        return w / w.sum()

    def train_round(self, state: RunState, t: int) -> RoundWork:
        """Stages 1-2: channel redraw, minibatch and churn draws, local
        training, quantize and aggregate, param update.  Updates
        ``state`` in place."""
        ecfg = self.engine_cfg
        if (ecfg.redraw_channel_every > 0 and state.chan is not None
                and t > 1 and (t - 1) % ecfg.redraw_channel_every == 0):
            state.chan = make_channel(state.chan.cfg,
                                      seed=ecfg.channel_seed + t)
        xs, ys = self.draw_minibatches(state)
        active = self._draw_active(state.part_rng)
        weights = torch.tensor(self._round_weights(active),
                               dtype=torch.float32, device=self.device)
        act = torch.tensor(active, dtype=torch.float32, device=self.device) \
            if ecfg.participation < 1.0 else None
        with torch.no_grad():
            step = self._fused_step if ecfg.effective_fused \
                else self._exact_step
            state.params, state.qstate, bits, aux = step(
                state.params, state.qstate, xs, ys, weights, act)
        bits_np = bits.double().cpu().numpy() * active
        s_np = aux["s"].double().cpu().numpy() if "s" in aux \
            else np.ones(self.K)
        mean_s = float(np.mean(s_np[active.astype(bool)]))
        return RoundWork(t=t, bits_np=bits_np, active=active,
                         mean_s=mean_s)

    def solve_uplink_host(self, chan: Optional[ChannelRealization],
                          bits_np: np.ndarray, active: np.ndarray
                          ) -> UplinkSolution:
        """Stage 3: the host power solve (numpy + scipy).  Under churn
        only active users transmit: the problem is solved on their
        sub-channel, so absent users neither get power nor interfere;
        their latencies stay 0."""
        per_user = np.zeros(self.K)
        if self.power is None or chan is None:
            return UplinkSolution(0.0, per_user)
        act_idx = np.flatnonzero(active)
        if len(act_idx) == self.K:
            sol = self.power.solve(chan, np.maximum(bits_np, 1.0))
            per_user = np.asarray(sol.latencies, np.float64)
        else:
            sol = self.power.solve(_subchannel(chan, act_idx),
                                   np.maximum(bits_np[act_idx], 1.0))
            per_user[act_idx] = np.asarray(sol.latencies, np.float64)
        return UplinkSolution(sol.straggler_latency, per_user)

    def eval_due(self, t: int) -> bool:
        return t % self.fl.eval_every == 0 or t == self.fl.T

    def budget_spent(self, cum_latency: float) -> bool:
        return (self.fl.latency_budget_s is not None
                and cum_latency >= self.fl.latency_budget_s)

    def finish_round(self, state: RunState, work: RoundWork,
                     uplink: float, verbose: bool = False,
                     per_user_s: Optional[np.ndarray] = None) -> bool:
        """Stage 4: latency accounting, eval, logging.  Returns False
        once the latency budget is exhausted (stop stepping)."""
        from repro_torch.fl.loop import RoundLog

        t = work.t
        gap = 0.0 if per_user_s is None \
            else straggler_gap(per_user_s, work.active)
        state.cum_latency += uplink + self.comp_lat
        acc = None
        if self.eval_due(t):
            acc = self.model_spec.accuracy(state.params, state.test_x,
                                           state.test_y)
        state.logs.append(RoundLog(
            t, work.bits_np, uplink, self.comp_lat, state.cum_latency,
            work.mean_s, acc, straggler_gap_s=gap,
            effective_participation=float(np.sum(work.active > 0)) / self.K))
        state.rounds_done = t
        if verbose and acc is not None:
            print(f"[round {t:4d}] acc={acc:.4f} "
                  f"bits/user={work.bits_np.mean():.3e} "
                  f"cum_lat={state.cum_latency:.2f}s")
        return not self.budget_spent(state.cum_latency)

    def result(self, state: RunState):
        from repro_torch.fl.loop import FLResult
        return FLResult(params=state.params, logs=state.logs,
                        rounds_completed=state.rounds_done)

    def run(self, verbose: bool = False):
        state = self.start_run()
        for t in range(1, self.fl.T + 1):
            work = self.train_round(state, t)
            uplink, per_user = self.solve_uplink_host(
                state.chan, work.bits_np, work.active)
            if not self.finish_round(state, work, uplink, verbose=verbose,
                                     per_user_s=per_user):
                break
        return self.result(state)

    # ------------------------------------------- replicated round API
    def _replicated_step(self, R: int):
        """The round's step over a leading replicate axis R, one call
        for all R trajectories.  R = 1 runs :meth:`_fused_step` itself
        on the squeezed tensors, so it is the unreplicated run bit for
        bit; R > 1 runs it under ``torch.func.vmap`` over R or loops it
        over the replicates (:attr:`EngineConfig.replicate_batching`)."""
        fused = self._fused_step

        def one(r, params, qstate, xs, ys, weights, active):
            """Replicate r's slice of the stacked arguments."""
            take = lambda x: x[r]
            return ({k: v[r] for k, v in params.items()},
                    _each(take, qstate), xs[r], ys[r], weights[r],
                    _each(take, active))

        if R == 1:
            def step1(*args):
                out = fused(*one(0, *args))
                return tuple(_each(lambda x: x[None], o) for o in out)
            return step1
        mode = self.engine_cfg.replicate_batching
        if mode == "auto":
            mode = "vmap" if self.device.type == "cuda" else "map"
        if self.wire_path_spec.plane in ("signplane", "packed"):
            mode = "map"        # the kernels take one replicate at a time
        if mode == "map":
            def step_map(*args):
                outs = [fused(*one(r, *args)) for r in range(R)]
                return tuple(
                    None if outs[0][i] is None
                    else tree_map(lambda *xs: torch.stack(xs),
                                  *[o[i] for o in outs])
                    for i in range(4))
            return step_map

        def step_vmap(params, qstate, xs, ys, weights, active):
            q_dim = None if qstate is None else 0
            in_dims = (0, q_dim, 0, 0, 0, None if active is None else 0)
            try:
                return vmap(fused, in_dims=in_dims,
                            out_dims=(0, q_dim, 0, 0))(
                    params, qstate, xs, ys, weights, active)
            except torch.cuda.OutOfMemoryError:
                raise
            except RuntimeError as err:
                raise RuntimeError(
                    f"quantizer {self.quantizer.name!r} does not run under "
                    "the replicate vmap; configure "
                    "EngineConfig(replicate_batching=\"map\")") from err
        return step_vmap

    def _repl_chan_seed(self, r: int, t: int) -> int:
        return (self.engine_cfg.channel_seed
                + r * _REPL_CHANNEL_SEED_STRIDE + t)

    def start_replicated_run(self, R: int) -> ReplicatedRunState:
        """R fresh replicates: the engine's initial params and quantizer
        state copied R times (real copies, not views), replicate 0 on
        the unreplicated streams and channel."""
        if not self.engine_cfg.effective_fused:
            raise ValueError(
                "replicated mode vmaps the fused per-round step; "
                "configure EngineConfig(fused=True)")
        if R < 1:
            raise ValueError(f"need at least one replicate, got {R}")
        seed = self.fl.seed
        stack = lambda tr: _each(
            lambda x: x[None].repeat((R,) + (1,) * x.dim()), tr)
        chans: List[Optional[ChannelRealization]] = [self.chan]
        for r in range(1, R):
            chans.append(None if self.chan is None else make_channel(
                self.chan.cfg, seed=self._repl_chan_seed(r, 0)))
        return ReplicatedRunState(
            params=stack(self.params), qstate=stack(self.qstate),
            chans=chans,
            rngs=[np.random.default_rng(seed) if r == 0 else
                  np.random.default_rng((seed, _REPL_TAG, r))
                  for r in range(R)],
            part_rngs=[np.random.default_rng((seed, 0x5EED)) if r == 0
                       else np.random.default_rng((seed, 0x5EED,
                                                   _REPL_TAG, r))
                       for r in range(R)],
            test_x=torch.as_tensor(self.test.x, device=self.device),
            test_y=torch.as_tensor(self.test.y, device=self.device))

    def train_round_replicated(self, state: ReplicatedRunState, t: int
                               ) -> ReplicatedRoundWork:
        """All R replicates' channel redraws, minibatch and churn draws
        and one call of the replicated step for round t.  Updates
        ``state`` in place (new tensors; nothing is written into the
        old ones, so a snapshot of a replicate's params stays valid)."""
        ecfg, R = self.engine_cfg, state.R
        if ecfg.redraw_channel_every > 0 and t > 1 \
                and (t - 1) % ecfg.redraw_channel_every == 0:
            for r in range(R):
                if state.chans[r] is not None:
                    state.chans[r] = make_channel(
                        state.chans[r].cfg, seed=self._repl_chan_seed(r, t))
        # per replicate, the same nested draw order as train_round
        sel = np.stack([
            np.stack([np.stack([rng.choice(shard, self.take, replace=False)
                                for _ in range(self.fl.L)])
                      for shard in self.shards])
            for rng in state.rngs])                  # [R, K, L, b]
        idx = torch.as_tensor(sel, device=self.device)
        xs, ys = self._train_x[idx], self._train_y[idx]
        active = np.stack([self._draw_active(prng)
                           for prng in state.part_rngs])      # [R, K]
        weights = torch.tensor(
            np.stack([self._round_weights(a) for a in active]),
            dtype=torch.float32, device=self.device)
        act = torch.tensor(active, dtype=torch.float32, device=self.device) \
            if ecfg.participation < 1.0 else None
        with torch.no_grad():
            state.params, state.qstate, bits, aux = self._replicated_step(R)(
                state.params, state.qstate, xs, ys, weights, act)
        state.rounds_done = t
        bits_np = bits.double().cpu().numpy() * active
        s_np = aux["s"].double().cpu().numpy() if "s" in aux \
            else np.ones((R, self.K))
        mean_s = np.array([float(np.mean(s_np[r][active[r].astype(bool)]))
                           for r in range(R)])
        return ReplicatedRoundWork(t=t, bits_np=bits_np, active=active,
                                   mean_s=mean_s)

    def replicate_params(self, state: ReplicatedRunState, r: int) -> dict:
        """Replicate r's current params, a copy of its own."""
        return {k: v[r].clone() for k, v in state.params.items()}

    def eval_accuracy_replicated(self, state: ReplicatedRunState,
                                 alive: Optional[np.ndarray] = None
                                 ) -> np.ndarray:
        """Test accuracy per replicate [R], one replicate at a time (for
        R = 1 the unreplicated path's own call); NaN for replicates the
        ``alive`` mask leaves out."""
        accs = np.full(state.R, np.nan)
        rs = range(state.R) if alive is None else np.flatnonzero(alive)
        for r in rs:
            accs[r] = self.model_spec.accuracy(
                self.replicate_params(state, int(r)), state.test_x,
                state.test_y)
        return accs

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

User-axis scale and round modes (DESIGN.md §11–13):

* streaming cohorts (``WirePath(cohort_size=C)``, the packed plane):
  the fused step trains, encodes (K1, K2) and folds (K3 through its
  ``acc``) the users C at a time into one carried ``[d]`` accumulator,
  so no ``[K, d]`` delta buffer exists; a short last cohort is padded
  to C users at weight 0, and C >= K is one cohort of K users, the
  vectorized step bit for bit.  The users train under a ``vmap`` over
  the cohort, and a ``vmap`` batch of another size rounds the deltas
  another way, so C < K matches the vectorized step to a trajectory
  tolerance, not bit for bit;
* AP clusters (``WirePath(clusters=N)``, with cohorts): contiguous
  user groups, one partial ``[d]`` aggregate each, combined in fixed
  cluster order before one param update; the bits come from the
  gathered headers, so they do not depend on the clustering;
* per-layer budgets (``WirePath(budget=LayerBudget...)``, fused only):
  one mixed-resolution quantize or encode a budget segment with that
  segment's ``(lambda_, b)``; a uniform budget is ``budget=None``;
* async rounds (``EngineConfig(async_mode=True, staleness=...)`` with a
  deadline; fused, the dense or packed plane): :meth:`train_round`
  trains and encodes the fresh uploads, the host event clock
  (:func:`advance_async_clock`) decides what arrived, and
  :meth:`complete_round_async` aggregates the arrivals with staleness
  weights and shuffles the bounded-staleness buffer — two step calls a
  round whatever K and R.  Without a deadline the config is the sync
  reduction and runs the lockstep path itself.

The plane checksum, the mesh and resilience raise
:class:`NotImplementedError`.  The port has no observability taps.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from repro_torch.core.channel import (ChannelRealization, computation_latency,
                                      make_channel)
from repro_torch.core.power.base import PowerController
from repro_torch.core.quantize import Quantizer
from repro_torch.core.quantize.base import flatten_pytree, unflatten_pytree
from repro_torch.core.quantize.layer_budget import segmented_quantize
from repro_torch.data.federated import user_fractions, validate_shards
from repro_torch.data.synthetic import ImageDataset
from repro_torch.device import resolve_device
from repro_torch.dist.compressor import signplane_weighted_aggregate
from repro_torch.kernels import WirePath, check_packed_dim
from repro_torch.kernels.mixed_res import HEADER_LANES, code_words_per_row
from repro_torch.kernels.ops import (MixedResWire, mixed_res_encode,
                                     mixed_res_wire_aggregate,
                                     mixed_res_wire_reduce,
                                     segmented_wire_aggregate, sign_pad_len,
                                     wire_head_stats)


@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    """Async round deadline and staleness weighting.

    The server closes a round at ``min(deadline, time all pending
    uploads complete)``, the deadline ``deadline_s`` seconds or the
    ``deadline_quantile`` of the round's pending completion times (at
    most one of the two).  With neither set the config is "sync" (an
    infinite deadline: the lockstep round) and
    ``EngineConfig.async_active`` stays False under ``async_mode=True``.
    Arrivals weigh ``rho_j (1 + staleness_j)^-alpha`` renormalized
    (:func:`staleness_weights`); a missed upload waits at most
    ``max_staleness`` rounds (0 drops every miss)."""
    deadline_s: Optional[float] = None
    deadline_quantile: Optional[float] = None
    alpha: float = 0.0
    max_staleness: int = 2

    def __post_init__(self):
        if self.deadline_s is not None and self.deadline_quantile is not None:
            raise ValueError("set deadline_s OR deadline_quantile, not both")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.deadline_quantile is not None and not (
                0.0 < self.deadline_quantile <= 1.0):
            raise ValueError("deadline_quantile must be in (0, 1], got "
                             f"{self.deadline_quantile}")
        if self.alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}")

    @property
    def is_sync(self) -> bool:
        """No finite deadline: the lockstep reduction."""
        return (self.deadline_s is None or np.isinf(self.deadline_s)) \
            and self.deadline_quantile is None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs, as ``repro.sim.EngineConfig``: the exact mode by
    default (``fused=False``), the wire plane and its streaming knobs in
    ``wire``, churn (``participation``), channel redraws
    (``redraw_channel_every`` from ``channel_seed``) and async rounds
    (``async_mode`` with ``staleness``).  The mesh and resilience raise
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
    staleness: StalenessConfig = dataclasses.field(
        default_factory=StalenessConfig)
    mesh: Optional[object] = None
    resilience: Optional[object] = None

    def __post_init__(self):
        unported = {"mesh": (self.mesh, None),
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

    @property
    def async_active(self) -> bool:
        """True only when the async machinery engages: ``async_mode``
        AND a finite deadline.  Every async branch is gated on it, so
        ``async_mode=True`` with a sync :class:`StalenessConfig` runs
        the lockstep path itself."""
        return self.async_mode and not self.staleness.is_sync


# ------------------------------------------------- async event clock
def staleness_weights(rho: np.ndarray, staleness: np.ndarray,
                      arrived: np.ndarray, alpha: float) -> np.ndarray:
    """Normalized aggregation weights ``rho_j (1 + s_j)^-alpha`` over the
    arrived set: a convex combination a leading-batch row whenever
    anything arrived, all zero otherwise.  rho: [K]; staleness and
    arrived: [..., K] (staleness in rounds, 0 for fresh uploads)."""
    arr = np.asarray(arrived, bool)
    raw = (np.asarray(rho, np.float64)
           * (1.0 + np.asarray(staleness, np.float64)) ** (-float(alpha))
           * arr)
    tot = raw.sum(axis=-1, keepdims=True)
    return np.divide(raw, tot, out=np.zeros_like(raw), where=tot > 0)


class AsyncClockStep(NamedTuple):
    """One :func:`advance_async_clock` transition.  Arrays [B, K] unless
    noted; B is the replicate axis (1 unreplicated)."""
    round_s: np.ndarray            # [B] event-clock round duration
    arrived: np.ndarray            # bool: aggregated this round
    w_fresh: np.ndarray            # weights of arrived fresh uploads
    w_buf: np.ndarray              # weights of arrived buffered uploads
    move: np.ndarray               # fresh upload missed -> enters buffer
    keep: np.ndarray               # buffered upload missed -> stays
    in_flight: np.ndarray          # next round's busy mask (move | keep)
    remaining_s: np.ndarray        # next round's remaining upload time
    staleness: np.ndarray          # next round's buffer staleness
    arrived_staleness: np.ndarray  # staleness of each arrival (0 fresh)
    dropped_stale: np.ndarray      # [B] uploads dropped: staleness bound
    dropped_churn: np.ndarray      # [B] uploads dropped: user churned out
    straggler_gap_s: np.ndarray    # [B] max - median pending completion


def advance_async_clock(in_flight: np.ndarray, remaining_s: np.ndarray,
                        staleness: np.ndarray, ell: np.ndarray,
                        fresh: np.ndarray, participating: np.ndarray,
                        rho: np.ndarray, cfg: StalenessConfig
                        ) -> AsyncClockStep:
    """The host event clock's transition for one async round (numpy).

    Inputs are [B, K]: ``in_flight``, ``remaining_s`` and ``staleness``
    the buffer state, ``ell`` the round's per-user solve latencies (the
    fresh uploads'), ``fresh`` the fresh-uploader mask and
    ``participating`` the churn mask.

    * an in-flight upload whose user churned out is dropped, never
      aggregated;
    * the round closes at ``min(deadline, max pending completion)``, so
      with every pending upload inside the deadline it lasts the
      lockstep straggler latency;
    * arrivals (completion <= round_s) weigh :func:`staleness_weights`;
      misses enter or stay in the buffer with ``remaining_s`` less the
      elapsed round and staleness one more, and are dropped once
      ``staleness > cfg.max_staleness``."""
    part = np.asarray(participating) > 0
    fresh = np.asarray(fresh) > 0
    churn_drop = in_flight & ~part
    busy = in_flight & part
    cand = np.where(fresh, np.asarray(ell, np.float64), np.inf)
    cand = np.where(busy, remaining_s, cand)
    pending = fresh | busy
    B = cand.shape[0]
    round_s = np.zeros(B)
    gap = np.zeros(B)
    for b in range(B):
        pc = cand[b][pending[b]]
        if pc.size == 0:
            continue
        if cfg.deadline_s is not None:
            deadline = float(cfg.deadline_s)
        else:
            deadline = float(np.quantile(pc, cfg.deadline_quantile))
        # a server that saw every pending upload land early closes the
        # round then: deadline_s=inf is the lockstep round
        round_s[b] = min(deadline, float(pc.max()))
        gap[b] = float(pc.max() - np.median(pc))
    arrived = pending & (cand <= round_s[:, None])
    arr_stale = np.where(busy, staleness, 0)
    w = staleness_weights(rho, arr_stale, arrived, cfg.alpha)
    # misses: fresh ones enter the buffer at staleness 1 (dropped
    # outright when max_staleness == 0); buffered ones age one round
    miss_fresh = fresh & ~arrived
    miss_buf = busy & ~arrived
    stale_drop = miss_buf & (staleness + 1 > cfg.max_staleness)
    keep = miss_buf & ~stale_drop
    move = miss_fresh if cfg.max_staleness >= 1 \
        else np.zeros_like(miss_fresh)
    elapsed = round_s[:, None]
    return AsyncClockStep(
        round_s=round_s, arrived=arrived,
        w_fresh=w * (fresh & arrived), w_buf=w * (busy & arrived),
        move=move, keep=keep, in_flight=move | keep,
        remaining_s=np.where(move, cand - elapsed,
                             np.where(keep, remaining_s - elapsed, 0.0)),
        staleness=np.where(move, 1, np.where(keep, staleness + 1, 0)),
        arrived_staleness=np.where(arrived, arr_stale, 0),
        dropped_stale=(stale_drop | (miss_fresh & ~move)).sum(axis=-1),
        dropped_churn=churn_drop.sum(axis=-1),
        straggler_gap_s=gap)


@dataclasses.dataclass
class AsyncClock:
    """The async buffer state of a run.  Host arrays are [B, K] (B = 1
    unreplicated, else R); ``buffer`` holds the parked device payloads,
    dense ``[(R,) K, d]`` recons or a :class:`MixedResWire` of packed
    planes, a slot a user (at most one in-flight upload a user);
    ``payload`` holds the round's fresh payload between
    ``train_round`` and ``complete_round_async``."""
    in_flight: np.ndarray
    remaining_s: np.ndarray
    staleness: np.ndarray
    buffer: object
    payload: object = None
    uploads_started: int = 0
    arrived_total: int = 0
    dropped_stale: int = 0
    dropped_churn: int = 0


@dataclasses.dataclass
class AsyncRoundInfo:
    """Per-round async accounting (arrays [B]; B = 1 unreplicated)."""
    round_uplink_s: np.ndarray     # event-clock round duration
    n_arrived: np.ndarray          # arrivals aggregated this round
    mean_staleness: np.ndarray     # mean staleness over arrivals
    max_staleness_obs: np.ndarray  # max staleness over arrivals
    straggler_gap_s: np.ndarray    # max - median pending completion
    dropped_stale: np.ndarray
    dropped_churn: np.ndarray
    effective_participation: np.ndarray   # n_arrived / K
    in_flight_next: np.ndarray     # buffer occupancy entering next round


class UplinkSolution(NamedTuple):
    """Structured result of the uplink power solve (stage 3):
    ``latencies`` the [K] per-user completion times, 0 for absent users
    (the async event clock's input)."""
    straggler_s: float
    latencies: np.ndarray


@dataclasses.dataclass
class RoundWork:
    """What one training round hands to the power-control stage.  In
    async mode ``active`` is the fresh-uploader mask (participating and
    not mid-upload) and ``participating`` the churn mask; in sync mode
    ``participating`` stays None."""
    t: int
    bits_np: np.ndarray            # [K] payload bits; 0 for absent users
    active: np.ndarray             # [K] 0/1 participation mask
    mean_s: float                  # mean high-res fraction (active users)
    participating: Optional[np.ndarray] = None   # [K] churn mask (async)


@dataclasses.dataclass
class ReplicatedRoundWork:
    """RoundWork with a leading Monte-Carlo replicate axis R."""
    t: int
    bits_np: np.ndarray            # [R, K] payload bits; 0 for absent users
    active: np.ndarray             # [R, K] 0/1 participation masks
    mean_s: np.ndarray             # [R] mean high-res fraction per replicate
    participating: Optional[np.ndarray] = None   # [R, K] churn masks (async)


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
    async_clock: Optional[AsyncClock] = None


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
    async_clock: Optional[AsyncClock] = None

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


def _as_int(t: torch.Tensor) -> torch.Tensor:
    """A uint32 plane as int32 (the same bits), for the ops torch has no
    uint32 kernel for on every device."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _like(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if t.dtype != dtype else t


def _payload_map(fn, *payloads):
    """``fn`` over the tensors of async payloads: one dense tensor each,
    or :class:`MixedResWire` s plane by plane (uint32 planes through
    int32 views, returned as uint32)."""
    if isinstance(payloads[0], MixedResWire):
        return MixedResWire(*(
            _like(fn(*(_as_int(t) for t in planes)), planes[0].dtype)
            for planes in zip(*payloads)))
    return fn(*payloads)


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
        self.engine_cfg = ecfg = engine or EngineConfig()
        if ecfg.replicate_batching not in ("auto", "map", "vmap"):
            raise ValueError(f"unknown replicate_batching "
                             f"{ecfg.replicate_batching!r}")
        self.wire_path_spec = wp = ecfg.wire
        plane = wp.plane
        self._cohort, self._clusters = wp.cohort_size, wp.clusters
        if (plane in ("signplane", "packed")
                and quantizer.name != "mixed-resolution"):
            raise ValueError(
                f"the {plane} wire plane packs the mixed-resolution "
                f"wire format; quantizer {quantizer.name!r} has none")
        if plane == "packed" and quantizer.b > 16:
            raise ValueError(
                "the wire kernels store magnitude codes in <= 16 bits; "
                f"got b={quantizer.b}")
        if ecfg.async_active:
            if not ecfg.effective_fused:
                raise ValueError(
                    "async rounds split the fused step into train and "
                    "aggregate calls; configure EngineConfig(fused=True)")
            if plane == "signplane":
                raise ValueError(
                    "async rounds buffer packed payloads; use the "
                    "'packed' plane (full wire format) or 'dense'")
            if wp.streaming:
                raise ValueError(
                    "async rounds buffer full-K payload slots; cohort "
                    "streaming (WirePath.cohort_size) is lockstep-only")
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
        self._segments = self._resolve_budget_segments(wp)
        self.qstate = quantizer.init_batched_state(self.K, self.d,
                                                   device=self.device)
        self.comp_lat = computation_latency(fl.L, fl.dataset_size_for_comp,
                                            self.K)
        # the datasets live on the device for the whole run; each round
        # gathers its minibatches there from host-drawn indices
        self._train_x = torch.as_tensor(dataset.x, device=self.device)
        self._train_y = torch.as_tensor(dataset.y, device=self.device)

    def _resolve_budget_segments(self, wp: WirePath):
        """``WirePath.budget`` resolved against the params: the segment
        tuple of a non-uniform budget, or None (no budget or a uniform
        one: the global path, bit for bit)."""
        budget = wp.effective_budget
        if budget is None:
            return None
        q, ecfg = self.quantizer, self.engine_cfg
        if q.name != "mixed-resolution":
            raise ValueError(
                "per-layer budgets re-parameterize the mixed-resolution "
                f"scheme per segment; quantizer {q.name!r} has no "
                "(lambda_, b) budget")
        if not ecfg.effective_fused:
            raise ValueError(
                "per-layer budgets run per-segment quantization inside "
                "the fused step; configure EngineConfig(fused=True) "
                "(the exact mode is global-budget by definition)")
        if ecfg.async_active:
            raise ValueError(
                "per-layer budgets are not supported in async mode yet; "
                "use LayerBudget.uniform() or sync rounds")
        segments = budget.segments_for(self.params, q.lambda_, q.b)
        if wp.plane == "packed":
            for seg in segments:
                if seg.b > 16:
                    raise ValueError(
                        "the wire kernels store magnitude codes in <= 16 "
                        f"bits; budget group {seg.group!r} has b={seg.b}")
        return segments

    # ------------------------------------------------------------ step
    def _batched_local(self, params, xs, ys) -> torch.Tensor:
        """All stacked users' local AdaGrad runs -> [U, d] deltas (U = K,
        or one cohort), in ``flatten_pytree``'s leaf order: one ``vmap``
        over the users (the fused mode)."""
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
        if self._segments is not None:
            # a per-layer budget: one encode + reduce (packed) or one
            # quantize (dense) a segment; mixed-resolution is stateless
            if path.plane == "packed":
                agg, bits, aux = segmented_wire_aggregate(
                    flat, w, self._segments, path=path)
            else:
                recon, bits, aux = segmented_quantize(flat, self._segments)
                agg = torch.einsum("k,kd->d", w, recon)
            return agg, bits, aux, qstate
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

    def _apply(self, params, upd_flat: torch.Tensor) -> dict:
        upd = unflatten_pytree(upd_flat, self.spec)
        return {k: params[k] + upd[k] for k in params}

    def _fused_step(self, params, qstate, xs, ys, weights=None,
                    active=None):
        if self._cohort is not None:
            # streaming cohorts: C users at a time into one carried [d]
            # accumulator; no [K, d] buffer
            acc, head = self._cohort_accumulate(
                params, xs, ys, self._weights if weights is None
                else weights)
            bits, aux = wire_head_stats(head, self.quantizer.b, self.d)
            return self._apply(params, acc), qstate, bits, aux
        flat = self._batched_local(params, xs, ys)
        agg, bits, aux, qstate = self.aggregate(flat, qstate, weights,
                                                active)
        return self._apply(params, agg), qstate, bits, aux

    def _cohort_accumulate(self, params, xs, ys, weights):
        """The U stacked users (U = K, or one AP cluster) in cohorts of
        C = min(cohort_size, K): each cohort trains (``vmap`` over its
        users), encodes (K1, the epilogue, K2) and folds its weighted
        planes into the carried accumulator (K3 with ``acc``), so at
        most C users' deltas exist at once.  The first cohort starts the
        fold as the one-shot reduce does, so the fold is the one-shot
        reduce's (DESIGN.md §12).  A short cohort is padded to C users
        with zero minibatches at weight 0 (their terms are +-0.0 and
        their headers are dropped), so every cohort trains under a vmap
        of C users.  Returns ``(acc [d], head [U, 8])``."""
        q, d, wp = self.quantizer, self.d, self.wire_path_spec
        C = min(self._cohort, self.K)
        U = xs.shape[0]
        acc, heads = None, []
        for c0 in range(0, U, C):
            n = min(C, U - c0)
            x_c, y_c, w_c = xs[c0:c0 + n], ys[c0:c0 + n], \
                weights[c0:c0 + n]
            if n < C:
                pad = lambda a: torch.cat(
                    [a, a.new_zeros((C - n,) + tuple(a.shape[1:]))])
                x_c, y_c, w_c = pad(x_c), pad(y_c), pad(w_c)
            flat = self._batched_local(params, x_c, y_c)      # [C, d]
            wire = mixed_res_encode(flat, q.lambda_, q.b, path=wp)
            del flat
            acc = mixed_res_wire_reduce(wire, w_c, q.b, d, acc=acc,
                                        path=wp)
            heads.append(wire.head[:n])
        return acc, torch.cat(heads)

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

    # ------------------------------------------------- async machinery
    # An async round splits the fused step in two: a train call making
    # the fresh payloads (no aggregate, no param update) and, once the
    # host event clock has decided who arrived, an aggregate + buffer
    # shuffle call.  Two step calls a round whatever K and R.
    def _async_train(self, params, qstate, xs, ys, commit):
        """(params, qstate, xs, ys, commit) -> (payload, qstate, bits,
        aux): the packed planes (K1, K2) or the dense recons of every
        user; only committing (fresh) users' quantizer state advances."""
        q, wp = self.quantizer, self.wire_path_spec
        flat = self._batched_local(params, xs, ys)
        if wp.plane == "packed":
            wire = mixed_res_encode(flat, q.lambda_, q.b, path=wp)
            bits, aux = wire_head_stats(wire.head, q.b, self.d)
            return wire, qstate, bits, aux
        res, new_qstate = q.batched(flat, qstate)
        return (res.recon, self._freeze_absent(new_qstate, qstate, commit),
                res.bits, res.aux)

    def _async_agg(self, params, fresh, buf, w_fresh, w_buf, move, keep):
        """(params, fresh, buf, w_fresh, w_buf, move, keep) -> (params,
        buffer): the staleness-weighted update over the arrived fresh
        and buffered payloads (all-zero weights: params unchanged), and
        the buffer shuffle (missed fresh payloads move in, kept misses
        stay, the rest zero out).  On the packed plane one K3 folds the
        fresh and the buffered planes, 2K slots."""
        q, wp, K = self.quantizer, self.wire_path_spec, self.K
        if wp.plane == "packed":
            stacked = _payload_map(lambda f, bu: torch.cat([f, bu]),
                                   fresh, buf)
            upd = mixed_res_wire_reduce(stacked, torch.cat([w_fresh, w_buf]),
                                        q.b, self.d, path=wp)
        else:
            upd = (torch.einsum("k,kd->d", w_fresh, fresh)
                   + torch.einsum("k,kd->d", w_buf, buf))

        def shuffle(f, bu):
            shape = (K,) + (1,) * (f.dim() - 1)
            m, kp = move.reshape(shape) > 0, keep.reshape(shape) > 0
            return torch.where(m, f, torch.where(kp, bu,
                                                 torch.zeros_like(bu)))

        return self._apply(params, upd), _payload_map(shuffle, fresh, buf)

    def _async_steps(self, R: Optional[int] = None) -> Tuple:
        """(train, agg), the async round's two step calls, for replicate
        count R (None: unreplicated), over the replicates as
        :meth:`_over_replicates` runs them."""
        train, agg = self._async_train, self._async_agg
        if R is None:
            return train, agg
        q_dim = None if self.qstate is None else 0
        return (self._over_replicates(train, R, (0, q_dim, 0, 0)),
                self._over_replicates(agg, R, 0))

    def _init_async_clock(self, R: Optional[int] = None) -> AsyncClock:
        """An empty bounded-staleness buffer: host masks clear, device
        payload slots all zero (a zero slot at weight zero adds exactly
        nothing to the aggregate)."""
        B = 1 if R is None else R
        K, d, dev = self.K, self.d, self.device
        lead = (K,) if R is None else (R, K)
        if self.wire_path_spec.plane == "packed":
            W = sign_pad_len(d) // 128
            u32 = lambda *shape: torch.zeros(lead + shape,
                                             dtype=torch.uint32, device=dev)
            buffer = MixedResWire(
                signs=u32(W, 4), hi=u32(W, 4),
                codes=u32(W, code_words_per_row(self.quantizer.b)),
                head=torch.zeros(lead + (HEADER_LANES,), device=dev))
        else:
            buffer = torch.zeros(lead + (d,), device=dev)
        return AsyncClock(
            in_flight=np.zeros((B, K), bool),
            remaining_s=np.zeros((B, K)),
            staleness=np.zeros((B, K), np.int64),
            buffer=buffer)

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
            logs=[],
            async_clock=self._init_async_clock()
            if self.engine_cfg.async_active else None)

    def _draw_sel(self, rng: np.random.Generator) -> np.ndarray:
        """The round's [K, L, b] minibatch indices from ``rng``, in the
        JAX engine's nested draw order."""
        return np.stack([
            np.stack([rng.choice(shard, self.take, replace=False)
                      for _ in range(self.fl.L)])
            for shard in self.shards])

    def _gather(self, sel: np.ndarray):
        idx = torch.as_tensor(sel, device=self.device)
        return self._train_x[idx], self._train_y[idx]

    def draw_minibatches(self, state: RunState):
        """The round's [K, L, b, ...] minibatches from ``state.rng``, in
        the JAX engine's nested draw order, gathered on the device."""
        return self._gather(self._draw_sel(state.rng))

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

    def _f32(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=self.device)

    def _mean_s(self, aux, mask: np.ndarray):
        """Mean high-res fraction over the ``mask`` users (1.0 a user
        for a quantizer without one; 0.0 when nobody is in ``mask``):
        a float for a [K] mask, one a replicate [R] for an [R, K]
        mask."""
        m = np.asarray(mask).astype(bool)
        s_np = aux["s"].double().cpu().numpy() if "s" in aux \
            else np.ones(m.shape)
        out = np.array([float(np.mean(s[mr])) if mr.any() else 0.0
                        for s, mr in zip(s_np.reshape(-1, self.K),
                                         m.reshape(-1, self.K))])
        return float(out[0]) if m.ndim == 1 else out

    def train_round(self, state: RunState, t: int) -> RoundWork:
        """Stages 1-2: channel redraw, minibatch and churn draws, local
        training, quantize and aggregate, param update.  Updates
        ``state`` in place.  In async mode the aggregate waits for
        :meth:`complete_round_async`; with AP clusters the round runs
        cluster by cluster (:meth:`_clustered_round`)."""
        ecfg = self.engine_cfg
        if (ecfg.redraw_channel_every > 0 and state.chan is not None
                and t > 1 and (t - 1) % ecfg.redraw_channel_every == 0):
            state.chan = make_channel(state.chan.cfg,
                                      seed=ecfg.channel_seed + t)
        sel = self._draw_sel(state.rng)
        active = self._draw_active(state.part_rng)
        if self._clusters > 1:
            # only one cluster's minibatches are gathered at a time
            return self._clustered_round(state, t, sel, active)
        xs, ys = self._gather(sel)
        if ecfg.async_active:
            # busy users (mid-upload) start no fresh upload; the
            # aggregate waits until the event clock knows the arrivals
            clock = state.async_clock
            fresh = active * (~clock.in_flight[0]).astype(np.float64)
            train_step, _ = self._async_steps(None)
            with torch.no_grad():
                clock.payload, state.qstate, bits, aux = train_step(
                    state.params, state.qstate, xs, ys, self._f32(fresh))
            clock.uploads_started += int(fresh.sum())
            return RoundWork(t=t, bits_np=bits.double().cpu().numpy() * fresh,
                             active=fresh, mean_s=self._mean_s(aux, fresh),
                             participating=active)
        weights = self._f32(self._round_weights(active))
        act = self._f32(active) if ecfg.participation < 1.0 else None
        with torch.no_grad():
            step = self._fused_step if ecfg.effective_fused \
                else self._exact_step
            state.params, state.qstate, bits, aux = step(
                state.params, state.qstate, xs, ys, weights, act)
        return RoundWork(t=t, bits_np=bits.double().cpu().numpy() * active,
                         active=active, mean_s=self._mean_s(aux, active))

    def _clustered_round(self, state: RunState, t: int, sel: np.ndarray,
                         active: np.ndarray) -> RoundWork:
        """AP clusters (``WirePath.clusters > 1``, DESIGN.md §12): the K
        users split into contiguous groups (``np.array_split``), each
        group's minibatches gathered alone and its cohort fold a partial
        [d] aggregate; the partials add up in fixed cluster order before
        one param update.  Neither a [K, d] buffer nor the K-user
        minibatch stack exists.  Adding partials reassociates the user
        fold, so this matches ``clusters=1`` to f32 roundoff; the bits
        come from the gathered headers through the flat step's
        arithmetic, so they are the same whatever the clustering."""
        weights = self._f32(self._round_weights(active))
        total, heads = None, []
        with torch.no_grad():
            for g in np.array_split(np.arange(self.K), self._clusters):
                if len(g) == 0:
                    continue
                xs, ys = self._gather(sel[g])
                part, head = self._cohort_accumulate(
                    state.params, xs, ys,
                    weights[torch.as_tensor(g, device=self.device)])
                total = part if total is None else total + part
                heads.append(head)
            state.params = self._apply(state.params, total)
            bits, aux = wire_head_stats(torch.cat(heads), self.quantizer.b,
                                        self.d)
        return RoundWork(t=t, bits_np=bits.double().cpu().numpy() * active,
                         active=active, mean_s=self._mean_s(aux, active))

    def solve_uplink_host(self, chan: Optional[ChannelRealization],
                          bits_np: np.ndarray, active: np.ndarray
                          ) -> UplinkSolution:
        """Stage 3: the host power solve (numpy + scipy).  Under churn
        only active users transmit: the problem is solved on their
        sub-channel, so absent users neither get power nor interfere;
        their latencies stay 0.  An async round with no fresh uploader
        solves nothing."""
        per_user = np.zeros(self.K)
        if self.power is None or chan is None:
            return UplinkSolution(0.0, per_user)
        act_idx = np.flatnonzero(active)
        if len(act_idx) == 0:
            return UplinkSolution(0.0, per_user)
        if len(act_idx) == self.K:
            sol = self.power.solve(chan, np.maximum(bits_np, 1.0))
            per_user = np.asarray(sol.latencies, np.float64)
        else:
            sol = self.power.solve(_subchannel(chan, act_idx),
                                   np.maximum(bits_np[act_idx], 1.0))
            per_user[act_idx] = np.asarray(sol.latencies, np.float64)
        return UplinkSolution(sol.straggler_latency, per_user)

    def solve_uplink_host_detailed(
            self, chan: Optional[ChannelRealization], bits_np: np.ndarray,
            active: np.ndarray) -> UplinkSolution:
        """Deprecated alias of :meth:`solve_uplink_host`, which returns
        the full :class:`UplinkSolution` itself."""
        warnings.warn(
            "solve_uplink_host_detailed is deprecated; "
            "solve_uplink_host now returns an UplinkSolution carrying "
            "both straggler_s and latencies", DeprecationWarning,
            stacklevel=2)
        return self.solve_uplink_host(chan, bits_np, active)

    # -------------------------------------------------- async complete
    def _advance_clock(self, clock: AsyncClock, active: np.ndarray,
                       participating: np.ndarray, ell: np.ndarray
                       ) -> Tuple[AsyncClockStep, AsyncRoundInfo]:
        """Run the host event clock and fold its transition into the
        clock's host state and drop counters (inputs [B, K])."""
        step = advance_async_clock(
            clock.in_flight, clock.remaining_s, clock.staleness, ell,
            active, participating, self.rho, self.engine_cfg.staleness)
        clock.in_flight = step.in_flight
        clock.remaining_s = step.remaining_s
        clock.staleness = step.staleness
        clock.dropped_stale += int(step.dropped_stale.sum())
        clock.dropped_churn += int(step.dropped_churn.sum())
        clock.arrived_total += int(step.arrived.sum())
        n_arr = step.arrived.sum(axis=-1)
        stale_sum = step.arrived_staleness.sum(axis=-1)
        info = AsyncRoundInfo(
            round_uplink_s=step.round_s,
            n_arrived=n_arr,
            mean_staleness=np.divide(
                stale_sum, n_arr, out=np.zeros_like(step.round_s),
                where=n_arr > 0),
            max_staleness_obs=step.arrived_staleness.max(axis=-1),
            straggler_gap_s=step.straggler_gap_s,
            dropped_stale=step.dropped_stale,
            dropped_churn=step.dropped_churn,
            effective_participation=n_arr / float(self.K),
            in_flight_next=step.in_flight.sum(axis=-1))
        return step, info

    def _complete(self, state, work, per_user_s: np.ndarray, R=None
                  ) -> AsyncRoundInfo:
        clock = state.async_clock
        lead = (lambda a: np.asarray(a)[None]) if R is None \
            else np.asarray
        step, info = self._advance_clock(
            clock, lead(work.active), lead(work.participating),
            lead(np.asarray(per_user_s, np.float64)))
        _, agg_step = self._async_steps(R)
        row = (lambda a: self._f32(a[0])) if R is None else self._f32
        with torch.no_grad():
            state.params, clock.buffer = agg_step(
                state.params, clock.payload, clock.buffer,
                row(step.w_fresh), row(step.w_buf), row(step.move),
                row(step.keep))
        clock.payload = None
        return info

    def complete_round_async(self, state: RunState, work: RoundWork,
                             per_user_s: np.ndarray) -> AsyncRoundInfo:
        """Async stage 3.5: the host event clock and the aggregate +
        buffer shuffle call.  Call it on the training state (the one
        ``train_round`` advanced): it updates ``state.params``;
        ``finish_round`` never aggregates."""
        return self._complete(state, work, per_user_s)

    def eval_due(self, t: int) -> bool:
        return t % self.fl.eval_every == 0 or t == self.fl.T

    def budget_spent(self, cum_latency: float) -> bool:
        return (self.fl.latency_budget_s is not None
                and cum_latency >= self.fl.latency_budget_s)

    def round_log_fields(self, uplink: float, active: np.ndarray,
                         async_info: Optional[AsyncRoundInfo] = None,
                         per_user_s: Optional[np.ndarray] = None, r: int = 0
                         ) -> Tuple[float, dict]:
        """(the round's uplink seconds, the ``RoundLog`` fields of the
        straggler gap, participation, staleness and drops) for one
        trajectory (replicate ``r`` of ``async_info``).  An async round
        costs the event clock's duration (what the server waited), not
        ``uplink``, the slowest user's."""
        if async_info is not None:
            return float(async_info.round_uplink_s[r]), dict(
                straggler_gap_s=float(async_info.straggler_gap_s[r]),
                effective_participation=float(
                    async_info.effective_participation[r]),
                mean_staleness=float(async_info.mean_staleness[r]),
                dropped_uploads=int(async_info.dropped_stale[r]
                                    + async_info.dropped_churn[r]))
        return float(uplink), dict(
            straggler_gap_s=0.0 if per_user_s is None
            else straggler_gap(per_user_s, active),
            effective_participation=float(np.sum(active > 0)) / self.K,
            mean_staleness=0.0, dropped_uploads=0)

    def finish_round(self, state: RunState, work: RoundWork,
                     uplink: float, verbose: bool = False,
                     async_info: Optional[AsyncRoundInfo] = None,
                     per_user_s: Optional[np.ndarray] = None) -> bool:
        """Stage 4: latency accounting, eval, logging.  Returns False
        once the latency budget is exhausted (stop stepping).  Never
        aggregates: an async caller runs :meth:`complete_round_async`
        first and passes its ``async_info``, and the round then costs
        the event clock's duration (what the server waited), not the
        slowest user's."""
        from repro_torch.fl.loop import RoundLog

        t = work.t
        uplink, fields = self.round_log_fields(uplink, work.active,
                                               async_info, per_user_s)
        state.cum_latency += uplink + self.comp_lat
        acc = None
        if self.eval_due(t):
            acc = self.model_spec.accuracy(state.params, state.test_x,
                                           state.test_y)
        state.logs.append(RoundLog(
            t, work.bits_np, uplink, self.comp_lat, state.cum_latency,
            work.mean_s, acc, **fields))
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
        async_on = self.engine_cfg.async_active
        state = self.start_run()
        for t in range(1, self.fl.T + 1):
            work = self.train_round(state, t)
            uplink, per_user = self.solve_uplink_host(
                state.chan, work.bits_np, work.active)
            info = self.complete_round_async(state, work, per_user) \
                if async_on else None
            if not self.finish_round(state, work, uplink, verbose=verbose,
                                     async_info=info, per_user_s=per_user):
                break
        return self.result(state)

    # ------------------------------------------- replicated round API
    def _replicated_step(self, R: int):
        """The round's step (:meth:`_fused_step`) over a leading
        replicate axis R, one call for all R trajectories."""
        q_dim = None if self.qstate is None else 0
        return self._over_replicates(self._fused_step, R, (0, q_dim, 0, 0))

    def _over_replicates(self, fn, R: int, out_dims):
        """``fn`` over a leading replicate axis R of its arguments (None
        arguments pass through).  R = 1 runs ``fn`` itself on the
        squeezed tensors, so it is the unreplicated call bit for bit;
        R > 1 runs it under ``torch.func.vmap`` over R (``out_dims``) or
        loops it over the replicates and stacks the outputs, uint32
        planes through int32 views
        (:attr:`EngineConfig.replicate_batching`; the wire planes always
        loop: their kernels take one replicate at a time)."""
        if R == 1:
            def step1(*args):
                out = fn(*(_each(lambda x: x[0], a) for a in args))
                return tuple(_each(lambda x: x[None], o) for o in out)
            return step1
        mode = self.engine_cfg.replicate_batching
        if mode == "auto":
            mode = "vmap" if self.device.type == "cuda" else "map"
        if self.wire_path_spec.plane in ("signplane", "packed"):
            mode = "map"
        stack = lambda *xs: _like(torch.stack([_as_int(x) for x in xs]),
                                  xs[0].dtype)
        if mode == "map":
            def step_map(*args):
                outs = [fn(*(_each(lambda x: x[r], a) for a in args))
                        for r in range(R)]
                return tuple(None if outs[0][i] is None
                             else tree_map(stack, *[o[i] for o in outs])
                             for i in range(len(outs[0])))
            return step_map

        def step_vmap(*args):
            in_dims = tuple(None if a is None else 0 for a in args)
            try:
                return vmap(fn, in_dims=in_dims, out_dims=out_dims)(*args)
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
        if self._clusters > 1:
            raise ValueError(
                "the AP-cluster hierarchy drives its per-cluster calls "
                "from the host; replicated mode is not supported with "
                "WirePath.clusters > 1")
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
            test_y=torch.as_tensor(self.test.y, device=self.device),
            async_clock=self._init_async_clock(R)
            if self.engine_cfg.async_active else None)

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
        xs, ys = self._gather(np.stack([self._draw_sel(rng)
                                        for rng in state.rngs]))
        active = np.stack([self._draw_active(prng)
                           for prng in state.part_rngs])      # [R, K]

        if ecfg.async_active:
            clock = state.async_clock
            fresh = active * (~clock.in_flight).astype(np.float64)
            train_step, _ = self._async_steps(R)
            with torch.no_grad():
                clock.payload, state.qstate, bits, aux = train_step(
                    state.params, state.qstate, xs, ys, self._f32(fresh))
            clock.uploads_started += int(fresh.sum())
            state.rounds_done = t
            return ReplicatedRoundWork(
                t=t, bits_np=bits.double().cpu().numpy() * fresh,
                active=fresh, mean_s=self._mean_s(aux, fresh),
                participating=active)
        weights = self._f32(np.stack([self._round_weights(a)
                                      for a in active]))
        act = self._f32(active) if ecfg.participation < 1.0 else None
        with torch.no_grad():
            state.params, state.qstate, bits, aux = self._replicated_step(R)(
                state.params, state.qstate, xs, ys, weights, act)
        state.rounds_done = t
        return ReplicatedRoundWork(t=t,
                                   bits_np=bits.double().cpu().numpy() * active,
                                   active=active, mean_s=self._mean_s(aux, active))

    def complete_round_replicated_async(
            self, state: ReplicatedRunState, work: ReplicatedRoundWork,
            per_user_s: np.ndarray) -> AsyncRoundInfo:
        """Replicated async stage 3.5: R event clocks advance on the
        host and one aggregate call updates all R replicates' params and
        buffers.  ``per_user_s``: [R, K] solve latencies."""
        return self._complete(state, work, per_user_s, R=state.R)

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

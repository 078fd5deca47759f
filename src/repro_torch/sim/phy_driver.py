"""Batched-phy sweep driver — one power solve per power spec a round.

``run_grid`` steps every (scenario, quantizer, power) cell's engine to
completion one cell at a time, paying one host numpy/scipy power solve
per cell per round.  :func:`run_grid_batched` runs all cells of a
scenario in lockstep over rounds and routes power control through the
batched :mod:`repro_torch.phy` solvers: cells sharing a power spec are
stacked into one ``ChannelBatch`` and solved in one batched call on the
device, so the host solves drop to one per power spec a round whatever
the grid's width.

Two more savings the lockstep buys:

* power control never feeds back into training, so all cells of a
  quantizer share ONE training track: the step runs once per quantizer
  a round, not once per (quantizer x power) cell.  A cell whose latency
  budget is spent keeps the params of its own last round while the
  track trains on (the engine never writes into old params);
* the stacked bundle is cached per power group, keyed on the
  realization objects themselves, and rebuilt only when some cell's
  realization changed (Monte-Carlo redraws).

Churn goes through the solvers' mask (the engine's sub-channel: absent
users get no power, interfere with nobody, never straggle).  Summaries
gain a ``max_p`` column, the largest power coefficient any user was
allotted over the run (<= 1: transmit power <= p_max).

Numerics: the batched solve runs in ``dtype`` (float32 by default, as
the JAX driver runs; float64 is the parity mode) while the host path is
numpy float64, so latencies agree to DESIGN.md section 7's tolerances,
not bit for bit.

``replicates=R`` (DESIGN.md section 8) adds the Monte-Carlo replicate
axis: every cell runs R independent trajectories (their own minibatch
and churn streams, channel realizations and quantizer state), still one
replicated train call per quantizer and one solve per power spec a
round (the R x cells problems stack into one flat bundle).  Summaries
become across-replicate means with ``<metric>_ci95`` half-widths, and
``SweepResult.result`` holds the per-replicate ``FLResult`` list.
``replicates=1`` reproduces the unreplicated driver bit for bit on
training metrics.

Async scenarios (``Scenario.async_active``, DESIGN.md section 11) keep
one training track per (quantizer, power) cell, since arrival times
feed back into training; the solve is still one batched call per power
spec a round, and after it each async cell runs the host event clock
and one aggregate call (``complete_round_async``) before its
accounting, which charges the event clock's round duration.

Resilience, checkpoints and the mesh are not ported and raise
:class:`NotImplementedError`; the port has no observability taps.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.power import PowerController
from repro_torch.device import resolve_device
from repro_torch.phy import (batched_solver, bundle_from_realization_grid,
                             bundle_from_realizations)

from .engine import (ReplicatedRoundWork, ReplicatedRunState, RoundWork,
                     RunState, UplinkSolution, VectorizedFLEngine)
from .metrics import summarize_replicates, write_metrics_csv
from .scenarios import Scenario, build_problem
from .sweep import (PowerSpec, QuantSpec, SweepCell, SweepResult,
                    _make_engine, _make_power, _resolve_scenario,
                    _to_result)


@dataclasses.dataclass
class _Track:
    """One quantizer's engine and its shared training state."""
    engine: VectorizedFLEngine
    state: RunState
    cells: List["_Cell"] = dataclasses.field(default_factory=list)

    @property
    def alive(self) -> bool:
        return any(c.alive for c in self.cells)


@dataclasses.dataclass
class _Cell:
    """One (quantizer, power) grid cell: its own latency accounting over
    the track's shared training trajectory."""
    track: _Track
    power: Optional[PowerController]
    qlabel: str
    plabel: str
    acct: RunState                 # logs / cum_latency / params snapshot
    alive: bool = True
    max_p: float = 0.0


@dataclasses.dataclass
class _ReplTrack:
    """One quantizer's engine and its shared R-replicate training state."""
    engine: VectorizedFLEngine
    state: ReplicatedRunState
    cells: List["_ReplCell"] = dataclasses.field(default_factory=list)

    @property
    def alive(self) -> bool:
        return any(c.alive.any() for c in self.cells)


@dataclasses.dataclass
class _ReplCell:
    """One (quantizer, power) cell with per-replicate accounting: an [R]
    alive mask (a replicate stops logging once ITS budget is spent),
    per-replicate logs and cumulative latency, and a params snapshot at
    each replicate's own stopping round."""
    track: _ReplTrack
    power: Optional[PowerController]
    qlabel: str
    plabel: str
    logs: List[List]               # [R] lists of RoundLog
    cum_latency: np.ndarray        # [R] float64
    alive: np.ndarray              # [R] bool
    rounds_done: np.ndarray        # [R] int
    params: List[object]           # [R] per-replicate final params
    max_p: float = 0.0


# power label -> (the realizations the bundle was built from, the bundle)
_BundleCache = Dict[str, Tuple[List[object], object]]


def _cached_bundle(cache: _BundleCache, plabel: str, flat: List[object],
                   build):
    """The cached bundle of ``plabel`` if it was built from exactly these
    realization objects (compared by identity, not ``id``: a redrawn
    realization may reuse a collected one's id), else a new one."""
    hit = cache.get(plabel)
    if (hit is None or len(hit[0]) != len(flat)
            or any(a is not b for a, b in zip(hit[0], flat))):
        cache[plabel] = (flat, build())
    return cache[plabel][1]


def _power_groups(cells, has_channel) -> Dict[str, List[int]]:
    """Cell indices by power label (one spec per label in a grid),
    leaving out cells with no power control or no channel."""
    groups: Dict[str, List[int]] = {}
    for i, cell in enumerate(cells):
        if cell.power is not None and has_channel(cell.track.state):
            groups.setdefault(cell.plabel, []).append(i)
    return groups


def _payload(work_bits: np.ndarray, active: np.ndarray) -> np.ndarray:
    return np.where(active > 0, np.maximum(work_bits, 1.0), 1.0)


def _solve_round_batched(cells: List[_Cell], works: List[RoundWork],
                         cache: _BundleCache, dtype: torch.dtype, device
                         ) -> List[UplinkSolution]:
    """One batched solve per distinct power spec; one
    :class:`UplinkSolution` per cell (zeros without a channel)."""
    K0 = cells[0].track.engine.K if cells else 0
    uplinks = [0.0] * len(cells)
    per_user = [np.zeros(K0) for _ in cells]
    groups = _power_groups(cells, lambda st: st.chan is not None)
    for plabel, idx in groups.items():
        chans = [cells[i].track.state.chan for i in idx]
        cb = _cached_bundle(cache, plabel, chans,
                            lambda: bundle_from_realizations(
                                chans, dtype=dtype, device=device))
        mask = np.stack([works[i].active for i in idx])
        bits = np.stack([_payload(works[i].bits_np, works[i].active)
                         for i in idx])
        sol = batched_solver(cells[idx[0]].power)(cb, bits, mask=mask)
        stragglers = sol.straggler_latency.double().cpu().numpy()
        latencies = sol.latencies.double().cpu().numpy()
        p_max_round = torch.amax(sol.p, dim=-1).double().cpu().numpy()
        for row, i in enumerate(idx):
            uplinks[i] = float(stragglers[row])
            per_user[i] = latencies[row]
            cells[i].max_p = max(cells[i].max_p, float(p_max_round[row]))
    return [UplinkSolution(u, pu) for u, pu in zip(uplinks, per_user)]


def _run_scenario_lockstep(tracks: List[_Track], T: int, verbose: bool,
                           dtype: torch.dtype, device) -> None:
    cache: _BundleCache = {}
    for t in range(1, T + 1):
        live_tracks = [tr for tr in tracks if tr.alive]
        if not live_tracks:
            break
        # ONE training step per quantizer, shared by its cells
        track_work = {id(tr): tr.engine.train_round(tr.state, t)
                      for tr in live_tracks}
        live = [c for tr in live_tracks for c in tr.cells if c.alive]
        works = [track_work[id(c.track)] for c in live]
        sols = _solve_round_batched(live, works, cache, dtype, device)
        for cell, work, (uplink, pu) in zip(live, works, sols):
            eng = cell.track.engine
            # an async track is one (quantizer, power) cell, so the
            # aggregate completes on the track's own training state
            info = eng.complete_round_async(cell.track.state, work, pu) \
                if eng.engine_cfg.async_active else None
            # accounting sees the shared trajectory's current params (a
            # budget-stopped cell keeps those of ITS last round)
            cell.acct.params = cell.track.state.params
            cell.alive = eng.finish_round(
                cell.acct, work, uplink, verbose=verbose, async_info=info,
                per_user_s=pu)


def _solve_round_replicated(cells: List[_ReplCell],
                            works: List[ReplicatedRoundWork],
                            cache: _BundleCache, R: int,
                            dtype: torch.dtype, device
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """One batched solve per distinct power spec over the flattened
    cells x R axis; per-(cell, replicate) straggler latencies
    [n_cells, R] and per-user completion times [n_cells, R, K]."""
    K0 = cells[0].track.engine.K if cells else 0
    uplinks = np.zeros((len(cells), R))
    per_user = np.zeros((len(cells), R, K0))
    groups = _power_groups(cells, lambda st: st.chans[0] is not None)
    for plabel, idx in groups.items():
        # row i * R + r of the flat bundle is (cell idx[i], replicate r)
        grid = [cells[i].track.state.chans for i in idx]
        flat = [chan for row in grid for chan in row]
        cb = _cached_bundle(cache, plabel, flat,
                            lambda: bundle_from_realization_grid(
                                grid, dtype=dtype, device=device))
        K = flat[0].cfg.K
        mask = np.concatenate([works[i].active for i in idx])
        bits = np.concatenate([_payload(works[i].bits_np, works[i].active)
                               for i in idx])
        sol = batched_solver(cells[idx[0]].power)(cb, bits, mask=mask)
        n = len(idx)
        stragglers = sol.straggler_latency.double().cpu().numpy() \
            .reshape(n, R)
        latencies = sol.latencies.double().cpu().numpy().reshape(n, R, K)
        p_max_round = torch.amax(sol.p, dim=-1).double().cpu().numpy() \
            .reshape(n, R)
        for row, i in enumerate(idx):
            uplinks[i] = stragglers[row]
            per_user[i] = latencies[row]
            # max_p only over replicates still accounting: dead
            # replicates' rows ride along for a fixed shape
            if cells[i].alive.any():
                cells[i].max_p = max(
                    cells[i].max_p,
                    float(np.max(p_max_round[row][cells[i].alive])))
    return uplinks, per_user


def _run_scenario_lockstep_replicated(tracks: List[_ReplTrack], T: int,
                                      R: int, verbose: bool,
                                      dtype: torch.dtype, device) -> None:
    cache: _BundleCache = {}
    for t in range(1, T + 1):
        live_tracks = [tr for tr in tracks if tr.alive]
        if not live_tracks:
            break
        # ONE replicated training step per quantizer, all R replicates
        track_work = {id(tr): tr.engine.train_round_replicated(tr.state, t)
                      for tr in live_tracks}
        live = [c for tr in live_tracks for c in tr.cells if c.alive.any()]
        works = [track_work[id(c.track)] for c in live]
        uplinks, per_user = _solve_round_replicated(live, works, cache, R,
                                                    dtype, device)
        # async cells aggregate before the eval (sync cells aggregated
        # in the train step)
        infos = [cell.track.engine.complete_round_replicated_async(
                     cell.track.state, work, pu)
                 if cell.track.engine.engine_cfg.async_active else None
                 for cell, work, pu in zip(live, works, per_user)]
        # per-replicate accuracy, once per track on eval rounds, only for
        # replicates some cell still accounts
        track_acc: Dict[int, Optional[np.ndarray]] = {
            id(tr): tr.engine.eval_accuracy_replicated(
                tr.state, alive=np.logical_or.reduce(
                    [c.alive for c in tr.cells]))
            if tr.engine.eval_due(t) else None
            for tr in live_tracks}
        for cell, work, uplink, pu, info in zip(live, works, uplinks,
                                                per_user, infos):
            _finish_replicated_cell(cell, work, uplink, track_acc, t, R,
                                    verbose, async_info=info, per_user=pu)
    for tr in tracks:
        for cell in tr.cells:
            for r in np.flatnonzero(cell.alive):
                cell.params[r] = tr.engine.replicate_params(tr.state, int(r))


def _finish_replicated_cell(cell: _ReplCell, work: ReplicatedRoundWork,
                            uplink: np.ndarray,
                            track_acc: Dict[int, Optional[np.ndarray]],
                            t: int, R: int, verbose: bool,
                            async_info=None,
                            per_user: Optional[np.ndarray] = None) -> None:
    from repro_torch.fl.loop import RoundLog

    eng = cell.track.engine
    comp_lat = eng.comp_lat
    accs = track_acc[id(cell.track)]
    for r in np.flatnonzero(cell.alive):
        # async: the event clock's round duration burns the budget
        up, fields = eng.round_log_fields(
            uplink[r], work.active[r], async_info,
            None if per_user is None else per_user[r], r=int(r))
        cell.cum_latency[r] += up + comp_lat
        cell.logs[r].append(RoundLog(
            t, work.bits_np[r], up, comp_lat, float(cell.cum_latency[r]),
            float(work.mean_s[r]), None if accs is None else float(accs[r]),
            **fields))
        cell.rounds_done[r] = t
        if eng.budget_spent(cell.cum_latency[r]):
            cell.alive[r] = False
            # budget spent: THIS replicate's params at its final round,
            # a copy of its own, while the track trains on
            cell.params[r] = eng.replicate_params(cell.track.state, int(r))
    if verbose and accs is not None:
        # dead replicates carry NaN: average the live ones
        print(f"[round {t:4d}] {cell.qlabel}/{cell.plabel} "
              f"acc={np.nanmean(accs):.4f}±{np.nanstd(accs):.4f} (R={R})")


def _to_replicated_result(scn: Scenario, cell: _ReplCell) -> SweepResult:
    from repro_torch.fl.loop import FLResult

    results = [FLResult(params=cell.params[r], logs=cell.logs[r],
                        rounds_completed=int(cell.rounds_done[r]))
               for r in range(len(cell.logs))]
    summary = summarize_replicates([res.logs for res in results])
    summary["max_p"] = cell.max_p
    return SweepResult(cell=SweepCell(scn, cell.qlabel, cell.plabel),
                       result=results, summary=summary)


def run_grid_batched(scenarios: List[Union[str, Scenario]],
                     quantizers: Mapping[str, QuantSpec],
                     powers: Optional[Mapping[str, PowerSpec]] = None,
                     quick: bool = True, out_csv: Optional[str] = None,
                     latency_budget_s: Optional[float] = None,
                     verbose: bool = False, mesh=None,
                     replicates: Optional[int] = None,
                     resilience=None,
                     checkpoint_dir: Optional[str] = None, device=None,
                     dtype: torch.dtype = torch.float32
                     ) -> List[SweepResult]:
    """``run_grid`` on the batched phy path, on ``device`` (the card by
    default), the power solved in ``dtype``.

    Same grid and summaries (plus ``max_p``); within a scenario all
    cells advance round by round together and each round's power
    problems are solved in one batched call per power spec.

    ``replicates=R`` (int >= 1) switches a scenario to the Monte-Carlo
    replicate axis: R trajectories per cell, still one train call per
    quantizer and one solve per power spec a round; summaries gain
    mean/ci95 columns and ``SweepResult.result`` becomes the
    per-replicate ``FLResult`` list.  ``replicates=None`` keeps the
    unreplicated driver unless the scenario itself declares
    ``Scenario.replicates > 1``."""
    unported = {"mesh": mesh, "resilience": resilience,
                "checkpoint_dir": checkpoint_dir}
    for name, value in unported.items():
        if value is not None:
            raise NotImplementedError(
                f"run_grid_batched({name}=...) is not ported to "
                "repro_torch yet")
    if replicates is not None and replicates < 1:
        raise ValueError(f"replicates must be >= 1, got {replicates}")
    dev = resolve_device(device)
    powers = powers if powers is not None else {"none": None}
    results: List[SweepResult] = []
    for scenario in scenarios:
        scn = _resolve_scenario(scenario, quick, latency_budget_s)
        R = replicates if replicates is not None \
            else (scn.replicates if scn.replicates > 1 else None)
        problem = build_problem(scn)
        chan = problem[4]
        # sync cells of a quantizer share one training track (power never
        # feeds back into training); async arrival times do, so an async
        # scenario gets a track a (quantizer, power) cell
        pgroups = ([[item] for item in powers.items()]
                   if scn.async_active else [list(powers.items())])
        if R is not None:
            tracks_r: List[_ReplTrack] = []
            for (qlabel, qspec), group in itertools.product(
                    quantizers.items(), pgroups):
                engine = _make_engine(scn, problem, qspec, None, dev)
                track = _ReplTrack(engine=engine,
                                   state=engine.start_replicated_run(R))
                for plabel, pspec in group:
                    pc = _make_power(pspec)
                    track.cells.append(_ReplCell(
                        track=track, power=pc if chan is not None else None,
                        qlabel=qlabel, plabel=plabel,
                        logs=[[] for _ in range(R)],
                        cum_latency=np.zeros(R),
                        alive=np.ones(R, dtype=bool),
                        rounds_done=np.zeros(R, dtype=np.int64),
                        params=[None] * R))
                tracks_r.append(track)
            _run_scenario_lockstep_replicated(tracks_r, scn.T, R, verbose,
                                              dtype, dev)
            results += [_to_replicated_result(scn, cell)
                        for track in tracks_r for cell in track.cells]
        else:
            tracks: List[_Track] = []
            for (qlabel, qspec), group in itertools.product(
                    quantizers.items(), pgroups):
                engine = _make_engine(scn, problem, qspec, None, dev)
                track = _Track(engine=engine, state=engine.start_run())
                for plabel, pspec in group:
                    pc = _make_power(pspec)
                    acct = dataclasses.replace(track.state, logs=[],
                                               cum_latency=0.0,
                                               rounds_done=0)
                    track.cells.append(_Cell(
                        track=track, power=pc if chan is not None else None,
                        qlabel=qlabel, plabel=plabel, acct=acct))
                tracks.append(track)
            _run_scenario_lockstep(tracks, scn.T, verbose, dtype, dev)
            for track in tracks:
                for cell in track.cells:
                    res = _to_result(scn, track.engine,
                                     track.engine.result(cell.acct),
                                     (cell.qlabel, cell.plabel))
                    res.summary["max_p"] = cell.max_p
                    results.append(res)
    if out_csv:
        write_metrics_csv([r.row() for r in results], out_csv)
    return results


__all__ = ["run_grid_batched"]

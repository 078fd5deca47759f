"""repro_torch.sim — the vectorized FL-over-CFmMIMO engine's fused step
on the packed, signplane and dense wire planes, its Monte-Carlo
replicate axis, streaming cohorts and AP clusters, per-layer budgets and
async rounds (the host event clock), the scenario registry entries it
runs, round-log metrics, the cell and grid runners and the batched-phy
grid driver."""
from repro_torch.kernels import WirePath

from .engine import (AsyncClock, AsyncClockStep, AsyncRoundInfo,
                     EngineConfig, ReplicatedRoundWork, ReplicatedRunState,
                     RoundWork, RunState, StalenessConfig, UplinkSolution,
                     VectorizedFLEngine, advance_async_clock,
                     staleness_weights, straggler_gap)
from .metrics import (METRIC_FIELDS, REPLICATE_FIELDS, summarize_logs,
                      summarize_replicates, write_metrics_csv)
from .phy_driver import run_grid_batched
from .scenarios import (SCENARIOS, Scenario, async_scenarios, build_problem,
                        get_scenario, list_scenarios, register_scenario)
from .sweep import SweepCell, SweepResult, make_engine, run_cell, run_grid

__all__ = [
    "AsyncClock", "AsyncClockStep", "AsyncRoundInfo", "EngineConfig",
    "METRIC_FIELDS", "REPLICATE_FIELDS", "ReplicatedRoundWork",
    "ReplicatedRunState", "RoundWork", "RunState", "SCENARIOS", "Scenario",
    "StalenessConfig", "SweepCell", "SweepResult", "UplinkSolution",
    "VectorizedFLEngine", "WirePath", "advance_async_clock",
    "async_scenarios", "build_problem", "get_scenario", "list_scenarios",
    "make_engine", "register_scenario", "run_cell", "run_grid",
    "run_grid_batched", "staleness_weights", "straggler_gap",
    "summarize_logs", "summarize_replicates", "write_metrics_csv",
]

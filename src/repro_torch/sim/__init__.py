"""repro_torch.sim — the vectorized FL-over-CFmMIMO engine's fused step
on the packed, signplane and dense wire planes, the scenario registry
entries it runs, round-log metrics and the cell and grid runners."""
from repro_torch.kernels import WirePath

from .engine import (EngineConfig, RoundWork, RunState, UplinkSolution,
                     VectorizedFLEngine, straggler_gap)
from .metrics import METRIC_FIELDS, summarize_logs, write_metrics_csv
from .scenarios import (SCENARIOS, Scenario, build_problem, get_scenario,
                        list_scenarios, register_scenario)
from .sweep import SweepCell, SweepResult, make_engine, run_cell, run_grid

__all__ = [
    "EngineConfig", "METRIC_FIELDS", "RoundWork", "RunState", "SCENARIOS",
    "Scenario", "SweepCell", "SweepResult", "UplinkSolution",
    "VectorizedFLEngine", "WirePath", "build_problem", "get_scenario", "list_scenarios",
    "make_engine", "register_scenario", "run_cell", "run_grid",
    "straggler_gap", "summarize_logs", "write_metrics_csv",
]

"""Scenario x quantizer x power-controller sweep runner.

``run_cell`` and ``run_grid`` are ``repro.sim.sweep``'s on the port:

    from repro_torch.sim import run_grid
    results = run_grid(["paper-table3"],
                       quantizers={"mixed": ("mixed-resolution",
                                             {"lambda_": 0.4, "b": 4}),
                                   "laq": ("laq", {"b": 4, "xi": 0.5})},
                       powers={"ours": "bisection-lp",
                               "max-sum": "max-sum-rate"},
                       quick=True, out_csv="runs/sweep.csv")

Each cell runs the engine and summarizes its round logs
(``repro_torch.sim.metrics``).  Quantizer and power specs are registry
names (with optional kwargs) or ready instances.  ``phy_batched=True``
runs the grid on the batched phy path (``sim/phy_driver.py``), where
``replicates=R`` adds the Monte-Carlo replicate axis.  Async scenarios
(``async_mode=True`` with a deadline; ``scenarios.async_scenarios``
makes the staleness sweep axes) run through both: here each cell's
``engine.run`` drives the event clock on the host solve.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.core.power import PowerController, make_power_controller
from repro_torch.core.quantize import Quantizer, make_quantizer

from .engine import VectorizedFLEngine
from .metrics import summarize_logs, write_metrics_csv
from .scenarios import Scenario, build_problem, get_scenario

QuantSpec = Union[str, Tuple[str, Mapping[str, Any]], Quantizer]
PowerSpec = Union[None, str, Tuple[str, Mapping[str, Any]], PowerController]


def _make_quant(spec: QuantSpec) -> Quantizer:
    if isinstance(spec, Quantizer):
        return spec
    if isinstance(spec, str):
        return make_quantizer(spec)
    name, kwargs = spec
    return make_quantizer(name, **dict(kwargs))


def _make_power(spec: PowerSpec) -> Optional[PowerController]:
    if spec is None or isinstance(spec, PowerController):
        return spec
    if isinstance(spec, str):
        return make_power_controller(spec)
    name, kwargs = spec
    return make_power_controller(name, **dict(kwargs))


@dataclasses.dataclass(frozen=True)
class SweepCell:
    scenario: Scenario
    quantizer_label: str
    power_label: str


@dataclasses.dataclass
class SweepResult:
    cell: SweepCell
    result: Any                    # FLResult
    summary: Dict[str, float]

    def row(self) -> Dict[str, Any]:
        return {"scenario": self.cell.scenario.name,
                "quantizer": self.cell.quantizer_label,
                "power": self.cell.power_label, **self.summary}


def _resolve_scenario(scenario: Union[str, Scenario], quick: bool,
                      latency_budget_s: Optional[float]) -> Scenario:
    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    scn = scn.scaled(quick)
    if latency_budget_s is not None:
        scn = dataclasses.replace(scn, latency_budget_s=latency_budget_s)
    return scn


def _make_engine(scn: Scenario, problem, quantizer: QuantSpec,
                 power: PowerSpec, device, init_params=None
                 ) -> VectorizedFLEngine:
    from repro_torch.fl.loop import FLConfig

    train, test, shards, model, chan = problem
    fl = FLConfig(L=scn.L, T=scn.T, batch_size=scn.batch_size,
                  alpha=scn.lr, eval_every=scn.effective_eval_every,
                  latency_budget_s=scn.latency_budget_s, seed=scn.seed)
    pc = _make_power(power)
    return VectorizedFLEngine(train, test, shards, model,
                              _make_quant(quantizer),
                              pc if chan is not None else None, chan, fl,
                              engine=scn.engine_config(), device=device,
                              init_params=init_params)


def make_engine(scn: Scenario, quantizer: QuantSpec,
                power: PowerSpec = None, *, device=None,
                init_params=None) -> VectorizedFLEngine:
    """The engine for one cell of ``scn`` (already scaled), ready to
    ``run()`` or to step round by round."""
    return _make_engine(scn, build_problem(scn), quantizer, power, device,
                        init_params)


def _to_result(scn: Scenario, engine: VectorizedFLEngine, res,
               labels: Tuple[str, str]) -> SweepResult:
    qlabel = labels[0] or engine.quantizer.name
    plabel = labels[1] or (engine.power.name if engine.power is not None
                           else "none")
    return SweepResult(cell=SweepCell(scn, qlabel, plabel), result=res,
                       summary=summarize_logs(res.logs))


def run_cell(scenario: Union[str, Scenario], quantizer: QuantSpec,
             power: PowerSpec = None, quick: bool = True,
             latency_budget_s: Optional[float] = None,
             verbose: bool = False,
             labels: Tuple[str, str] = ("", ""),
             device=None) -> SweepResult:
    """Run one (scenario, quantizer, power) simulation cell on
    ``device`` (the card by default)."""
    scn = _resolve_scenario(scenario, quick, latency_budget_s)
    engine = make_engine(scn, quantizer, power, device=device)
    return _to_result(scn, engine, engine.run(verbose=verbose), labels)


def run_grid(scenarios: List[Union[str, Scenario]],
             quantizers: Mapping[str, QuantSpec],
             powers: Optional[Mapping[str, PowerSpec]] = None,
             quick: bool = True, out_csv: Optional[str] = None,
             latency_budget_s: Optional[float] = None,
             verbose: bool = False, device=None,
             phy_batched: bool = False,
             replicates: Optional[int] = None) -> List[SweepResult]:
    """Run the full scenario x quantizer x power grid on ``device`` (the
    card by default).

    Within a scenario the problem (dataset, partition, channel) is
    built once and each quantizer's engine is reused across the power
    axis: power control runs on the host, so only ``engine.power``
    changes, and every run starts from the engine's initial params and
    quantizer state.

    ``phy_batched=True`` routes power control through the batched
    :mod:`repro_torch.phy` solvers instead: all cells of a scenario
    advance in lockstep and each round's power problems are solved in
    one batched call per power spec (``run_grid_batched``), where
    ``replicates=R`` runs R Monte-Carlo replicates per cell."""
    if phy_batched:
        from .phy_driver import run_grid_batched
        return run_grid_batched(scenarios, quantizers, powers=powers,
                                quick=quick, out_csv=out_csv,
                                latency_budget_s=latency_budget_s,
                                verbose=verbose, replicates=replicates,
                                device=device)
    if replicates is not None:
        raise ValueError("replicates requires phy_batched=True (the "
                         "replicate axis lives in the batched driver)")
    powers = powers if powers is not None else {"none": None}
    results: List[SweepResult] = []
    for scenario in scenarios:
        scn = _resolve_scenario(scenario, quick, latency_budget_s)
        problem = build_problem(scn)
        chan = problem[4]
        for qlabel, qspec in quantizers.items():
            engine = None
            for plabel, pspec in powers.items():
                if engine is None:
                    engine = _make_engine(scn, problem, qspec, pspec, device)
                else:
                    pc = _make_power(pspec)
                    engine.power = pc if chan is not None else None
                results.append(_to_result(
                    scn, engine, engine.run(verbose=verbose),
                    (qlabel, plabel)))
    if out_csv:
        write_metrics_csv([r.row() for r in results], out_csv)
    return results

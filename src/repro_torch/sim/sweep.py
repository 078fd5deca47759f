"""Run one (scenario, quantizer, power controller) simulation cell.

``run_cell`` is ``repro.sim.sweep.run_cell`` on the port: it builds the
scenario's problem, runs the engine and summarizes the round logs.
The grid runners (``run_grid``, the batched phy driver) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from repro_torch.core.power import PowerController, make_power_controller
from repro_torch.core.quantize import Quantizer, make_quantizer

from .engine import VectorizedFLEngine
from .metrics import summarize_logs
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


def make_engine(scn: Scenario, quantizer: QuantSpec,
                power: PowerSpec = None, *, device=None,
                init_params=None) -> VectorizedFLEngine:
    """The engine for one cell of ``scn`` (already scaled), ready to
    ``run()`` or to step round by round."""
    from repro_torch.fl.loop import FLConfig

    ecfg = scn.engine_config()
    train, test, shards, model, chan = build_problem(scn)
    fl = FLConfig(L=scn.L, T=scn.T, batch_size=scn.batch_size,
                  alpha=scn.lr, eval_every=scn.effective_eval_every,
                  latency_budget_s=scn.latency_budget_s, seed=scn.seed)
    pc = _make_power(power)
    return VectorizedFLEngine(train, test, shards, model,
                              _make_quant(quantizer),
                              pc if chan is not None else None, chan, fl,
                              engine=ecfg, device=device,
                              init_params=init_params)


def run_cell(scenario: Union[str, Scenario], quantizer: QuantSpec,
             power: PowerSpec = None, quick: bool = True,
             latency_budget_s: Optional[float] = None,
             verbose: bool = False,
             labels: Tuple[str, str] = ("", ""),
             device=None) -> SweepResult:
    """Run one (scenario, quantizer, power) simulation cell on
    ``device`` (the card by default)."""
    scn = get_scenario(scenario) if isinstance(scenario, str) else scenario
    scn = scn.scaled(quick)
    if latency_budget_s is not None:
        scn = dataclasses.replace(scn, latency_budget_s=latency_budget_s)
    engine = make_engine(scn, quantizer, power, device=device)
    res = engine.run(verbose=verbose)
    qlabel = labels[0] or engine.quantizer.name
    plabel = labels[1] or (engine.power.name if engine.power is not None
                           else "none")
    return SweepResult(cell=SweepCell(scn, qlabel, plabel), result=res,
                       summary=summarize_logs(res.logs))

"""Uplink power control: the paper's bisection+LP controller and both
benchmarks (Dinkelbach energy efficiency, max-sum-rate)."""
from .base import PowerController, PowerSolution
from .bisection_lp import BisectionLPPowerControl, eta_upper_bound
from .bitalloc import equalizing_target_latency, rate_aware_fractions
from .dinkelbach import DinkelbachPowerControl
from .maxsum import MaxSumRatePowerControl

POWER_CONTROLLERS = {
    "bisection-lp": BisectionLPPowerControl,
    "dinkelbach": DinkelbachPowerControl,
    "max-sum-rate": MaxSumRatePowerControl,
}


def make_power_controller(name: str, **kwargs) -> PowerController:
    if name not in POWER_CONTROLLERS:
        raise KeyError(f"unknown power controller {name!r}; "
                       f"have {list(POWER_CONTROLLERS)}")
    return POWER_CONTROLLERS[name](**kwargs)


__all__ = ["BisectionLPPowerControl", "DinkelbachPowerControl",
           "MaxSumRatePowerControl", "POWER_CONTROLLERS", "PowerController",
           "PowerSolution", "equalizing_target_latency", "eta_upper_bound",
           "make_power_controller", "rate_aware_fractions"]

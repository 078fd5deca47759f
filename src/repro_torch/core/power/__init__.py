"""Uplink power control: the paper's bisection+LP controller.

The benchmark controllers (Dinkelbach, max-sum-rate) are not ported
yet; the registry holds ``"bisection-lp"`` only."""
from .base import PowerController, PowerSolution
from .bisection_lp import BisectionLPPowerControl, eta_upper_bound

POWER_CONTROLLERS = {
    "bisection-lp": BisectionLPPowerControl,
}


def make_power_controller(name: str, **kwargs) -> PowerController:
    if name not in POWER_CONTROLLERS:
        raise KeyError(f"unknown power controller {name!r}; "
                       f"have {list(POWER_CONTROLLERS)}")
    return POWER_CONTROLLERS[name](**kwargs)


__all__ = ["BisectionLPPowerControl", "POWER_CONTROLLERS",
           "PowerController", "PowerSolution", "eta_upper_bound",
           "make_power_controller"]

"""Optimizers on dicts of tensors: the port of ``repro.optim``."""
from .adagrad import adagrad
from .adam import adam
from .base import Optimizer, apply_updates
from .sgd import sgd

OPTIMIZERS = {"adagrad": adagrad, "adam": adam, "sgd": sgd}


def make_optimizer(name: str, **kwargs) -> Optimizer:
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; have {list(OPTIMIZERS)}")
    return OPTIMIZERS[name](**kwargs)


__all__ = ["OPTIMIZERS", "Optimizer", "adagrad", "adam", "apply_updates",
           "make_optimizer", "sgd"]

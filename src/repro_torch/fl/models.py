"""ModelSpec — the model contract the FL stack federates through.

Only the paper CNN is ported; the registry transformers
(``repro.fl.models.model_spec_from_arch``) wait for the LM zoo.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.paper_cnn import PaperCNNConfig

from .cnn import cnn_accuracy, cnn_loss, init_cnn


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """``init``: torch.Generator -> params dict (CPU); ``loss``:
    (params, x, y) -> scalar tensor (``torch.func`` grad- and
    vmap-safe); ``accuracy``: (params, x, y) -> float."""

    name: str
    init: Callable[..., Any]
    loss: Callable[[Any, Any, Any], Any]
    accuracy: Callable[[Any, Any, Any], float]
    config: Any = None


def as_model_spec(model) -> ModelSpec:
    """A ready :class:`ModelSpec`, or a :class:`PaperCNNConfig` resolved
    to the paper CNN's spec."""
    if isinstance(model, ModelSpec):
        return model
    if isinstance(model, PaperCNNConfig):
        cfg = model
        return ModelSpec(
            name="paper-cnn",
            init=lambda gen: init_cnn(gen, cfg),
            loss=cnn_loss, accuracy=cnn_accuracy, config=cfg)
    raise TypeError(
        f"expected a ModelSpec or PaperCNNConfig, got {type(model).__name__}")

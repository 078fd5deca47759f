"""Quantization: the paper's mixed-resolution scheme.

The benchmark quantizers (classic, LAQ, AQUILA, top-q, static budget)
and per-layer budgets are not ported yet; the registry holds
``"mixed-resolution"`` only."""
from .base import QuantResult, Quantizer, flatten_pytree, unflatten_pytree
from .mixed_resolution import (MixedResolutionQuantizer, lemma1_bound,
                               mixed_resolution_quantize)

QUANTIZERS = {
    "mixed-resolution": MixedResolutionQuantizer,
}


def make_quantizer(name: str, **kwargs) -> Quantizer:
    if name not in QUANTIZERS:
        raise KeyError(f"unknown quantizer {name!r}; have {list(QUANTIZERS)}")
    return QUANTIZERS[name](**kwargs)


__all__ = ["MixedResolutionQuantizer", "QUANTIZERS", "QuantResult",
           "Quantizer", "flatten_pytree", "lemma1_bound", "make_quantizer",
           "mixed_resolution_quantize", "unflatten_pytree"]

"""Quantization schemes: the paper's mixed-resolution scheme and the
benchmarks it is compared with (classic FL, LAQ, AQUILA, top-q).

Per-layer budgets, the static-budget wire format and the bit packing
helpers are not ported yet."""
from .aquila import AquilaQuantizer, aquila_quantize
from .base import QuantResult, Quantizer, flatten_pytree, unflatten_pytree
from .classic import ClassicQuantizer
from .laq import LAQQuantizer, LAQState, laq_quantize
from .mixed_resolution import (MixedResolutionQuantizer, lemma1_bound,
                               lemma1_bound_realized,
                               mixed_resolution_quantize)
from .topq import TopQQuantizer, topq_quantize

QUANTIZERS = {
    "mixed-resolution": MixedResolutionQuantizer,
    "classic": ClassicQuantizer,
    "laq": LAQQuantizer,
    "aquila": AquilaQuantizer,
    "top-q": TopQQuantizer,
}


def make_quantizer(name: str, **kwargs) -> Quantizer:
    if name not in QUANTIZERS:
        raise KeyError(f"unknown quantizer {name!r}; have {list(QUANTIZERS)}")
    return QUANTIZERS[name](**kwargs)


__all__ = ["AquilaQuantizer", "ClassicQuantizer", "LAQQuantizer",
           "LAQState", "MixedResolutionQuantizer", "QUANTIZERS",
           "QuantResult", "Quantizer", "TopQQuantizer", "aquila_quantize",
           "flatten_pytree", "laq_quantize", "lemma1_bound",
           "lemma1_bound_realized", "make_quantizer",
           "mixed_resolution_quantize", "topq_quantize", "unflatten_pytree"]

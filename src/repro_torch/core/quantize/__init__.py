"""Quantization schemes: the paper's mixed-resolution scheme and the
benchmarks it is compared with (classic FL, LAQ, AQUILA, top-q).

and per-layer budgets (:class:`LayerBudget`, DESIGN.md §13).  The
static-budget wire format and the bit packing helpers are not ported
yet."""
from .aquila import AquilaQuantizer, aquila_quantize
from .base import QuantResult, Quantizer, flatten_pytree, unflatten_pytree
from .classic import ClassicQuantizer
from .laq import LAQQuantizer, LAQState, laq_quantize
from .layer_budget import (BudgetRule, LayerBudget, Segment, classify_leaf,
                           resolve_segments, segmented_quantize,
                           validate_segments)
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


__all__ = ["AquilaQuantizer", "BudgetRule", "ClassicQuantizer",
           "LAQQuantizer", "LAQState", "LayerBudget",
           "MixedResolutionQuantizer", "QUANTIZERS", "QuantResult",
           "Quantizer", "Segment", "TopQQuantizer", "aquila_quantize",
           "classify_leaf", "flatten_pytree", "laq_quantize",
           "lemma1_bound", "lemma1_bound_realized", "make_quantizer",
           "mixed_resolution_quantize", "resolve_segments",
           "segmented_quantize", "topq_quantize", "unflatten_pytree",
           "validate_segments"]

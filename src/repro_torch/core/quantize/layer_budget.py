"""Per-layer mixed-resolution bit budgets (DESIGN.md §13), the port of
``repro.core.quantize.layer_budget``.

The paper's scheme spends one global ``(lambda_, b)`` budget on the
whole flattened model.  A :class:`LayerBudget` partitions the flattened
vector into contiguous *segments* of leaves that share a group label
(embedding, norm-like, matmul) and gives each group its own
mixed-resolution budget; the engine then runs one quantize or encode a
segment and accounts payload bits as the exact sum of the per-segment
bits.

Contract (``tests/test_torch_layer_budget.py``):

* ``LayerBudget.uniform()`` — no rules — keeps the global-budget path
  and is bit for bit ``budget=None`` in every engine mode;
* :func:`resolve_segments` walks the leaves in
  :func:`repro_torch.core.quantize.flatten_pytree`'s order (sorted dict
  keys, lists in sequence — JAX's ``tree_flatten`` order), so segment
  offsets index the flattened vector directly;
* a user's payload bits under a budget are
  ``sum_seg [d_seg (b_seg s_seg + 1 - s_seg) + 32]`` exactly (one
  32-bit header a segment).

A leaf's path is the string JAX's ``keystr`` gives it (``"['conv_w']"``,
``"['m'][0]"``), so a leaf routes to the same group in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.func import vmap

from repro_torch.kernels.ops import segment_stats, validate_segments

from .mixed_resolution import mixed_resolution_quantize

GROUPS = ("embed", "norm", "matmul")


@dataclasses.dataclass(frozen=True)
class BudgetRule:
    """Budget override for one leaf group.  Fields left ``None`` fall
    back to the caller's defaults at resolution time (the engine fills
    them from its quantizer)."""

    group: str
    lambda_: Optional[float] = None   # |x|/||x||_inf threshold (paper eq. 6)
    b: Optional[int] = None           # grid bits for high-res entries
    s_budget: Optional[float] = None  # the dist static high-res fraction

    def __post_init__(self):
        if self.group not in GROUPS + ("default",):
            raise ValueError(
                f"unknown budget group {self.group!r}; expected one of "
                f"{GROUPS + ('default',)}")
        if self.lambda_ is not None and not 0.0 <= float(self.lambda_) <= 1.0:
            raise ValueError(f"lambda_ must be in [0, 1], got {self.lambda_}")
        if self.b is not None and int(self.b) < 2:
            raise ValueError(f"b must be >= 2, got {self.b}")
        if self.s_budget is not None and not 0.0 < float(self.s_budget) <= 1.0:
            raise ValueError(
                f"s_budget must be in (0, 1], got {self.s_budget}")


class Segment(NamedTuple):
    """One contiguous run of same-budget leaves in the flattened vector."""

    start: int
    size: int
    lambda_: float
    b: int
    group: str
    s_budget: Optional[float] = None

    @property
    def stop(self) -> int:
        return self.start + self.size


@dataclasses.dataclass(frozen=True)
class LayerBudget:
    """Immutable, hashable per-group budget table.  An empty rule table
    is the *uniform* budget: consumers treat it exactly like "no
    budget" and keep their single-segment global path."""

    rules: Tuple[BudgetRule, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        seen = set()
        for r in self.rules:
            if not isinstance(r, BudgetRule):
                raise TypeError(f"rules must be BudgetRule, got {type(r)}")
            if r.group in seen:
                raise ValueError(f"duplicate rule for group {r.group!r}")
            seen.add(r.group)

    @classmethod
    def uniform(cls) -> "LayerBudget":
        """The identity budget: one global segment, the global path."""
        return cls(rules=())

    @classmethod
    def by_group(cls, **budgets) -> "LayerBudget":
        """``LayerBudget.by_group(norm=(0.1, 12), matmul=(0.3, 6))`` —
        values are ``(lambda_, b)`` or ``(lambda_, b, s_budget)`` tuples
        or ready :class:`BudgetRule` s (group taken from the keyword)."""
        rules = []
        for group, spec in sorted(budgets.items()):
            if isinstance(spec, BudgetRule):
                rules.append(dataclasses.replace(spec, group=group))
            else:
                rules.append(BudgetRule(group, *tuple(spec)))
        return cls(rules=tuple(rules))

    @property
    def is_uniform(self) -> bool:
        return not self.rules

    def rule_for(self, group: str) -> Optional[BudgetRule]:
        for r in self.rules:
            if r.group == group:
                return r
        for r in self.rules:
            if r.group == "default":
                return r
        return None

    def segments_for(self, tree, default_lambda: float, default_b: int,
                     default_s: Optional[float] = None,
                     skip_leading: int = 0) -> Tuple[Segment, ...]:
        """Resolve this budget against a concrete params/delta tree."""
        return resolve_segments(tree, self, default_lambda, default_b,
                                default_s=default_s,
                                skip_leading=skip_leading)


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """``(path, leaf)`` pairs in ``flatten_pytree``'s leaf order, each
    path spelled as JAX's ``keystr`` spells it."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def classify_leaf(path: str, leaf, skip_leading: int = 0) -> str:
    """Route one leaf to a budget group from its path and rank: names
    holding "embed", "lm_head" or "vocab" are embeddings; otherwise
    vectors and scalars are norm-like gains and biases and rank >= 2
    are matmul weights.  ``skip_leading`` discounts stacked batch
    axes, so a stacked norm gain still ranks as a vector."""
    name = str(path).lower()
    if any(tok in name for tok in ("embed", "lm_head", "vocab")):
        return "embed"
    shape = tuple(getattr(leaf, "shape", ()))[skip_leading:]
    if len(shape) <= 1:
        return "norm"
    return "matmul"


def resolve_segments(tree, budget: LayerBudget, default_lambda: float,
                     default_b: int, default_s: Optional[float] = None,
                     skip_leading: int = 0) -> Tuple[Segment, ...]:
    """Partition the flattened vector into contiguous budget segments.
    Adjacent leaves resolving to the same ``(group, lambda_, b,
    s_budget)`` merge into one segment."""
    segments: list = []
    offset = 0
    for path, leaf in leaves_with_path(tree):
        shape = tuple(getattr(leaf, "shape", ()))[skip_leading:]
        size = 1
        for s in shape:
            size *= int(s)
        group = classify_leaf(path, leaf, skip_leading)
        rule = budget.rule_for(group)
        lam = default_lambda if rule is None or rule.lambda_ is None \
            else float(rule.lambda_)
        b = default_b if rule is None or rule.b is None else int(rule.b)
        s_budget = default_s if rule is None or rule.s_budget is None \
            else float(rule.s_budget)
        if segments and segments[-1].group == group \
                and segments[-1].lambda_ == lam and segments[-1].b == b \
                and segments[-1].s_budget == s_budget:
            prev = segments[-1]
            segments[-1] = prev._replace(size=prev.size + size)
        else:
            segments.append(Segment(offset, size, lam, b, group, s_budget))
        offset += size
    return tuple(segments)


def segmented_quantize(flat: torch.Tensor, segments: Tuple[Segment, ...]
                       ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Dense-plane per-segment mixed-resolution quantize of [U, d] rows.

    Returns ``(recon [U, d], bits [U], aux)``: ``bits`` the exact sum of
    the per-segment payloads and ``aux["segment_bits"]`` the [U, n_seg]
    breakdown it sums."""
    U, d = flat.shape
    validate_segments(segments, d)
    recons, seg_bits, dbar = [], [], None
    for seg in segments:
        def one(v, lam=seg.lambda_, b=seg.b):
            res = mixed_resolution_quantize(v, lam, b)
            return res.recon, res.bits, res.aux["dbar"]

        recon, bits, db = vmap(one)(flat[:, seg.start:seg.stop])
        recons.append(recon)
        seg_bits.append(bits)
        dbar = db if dbar is None else dbar + db
    bits, aux = segment_stats(seg_bits, dbar, d)
    return torch.cat(recons, dim=1), bits, aux


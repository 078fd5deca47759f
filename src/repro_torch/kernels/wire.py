"""WirePath — which wire plane moves at the fan-in and which lowering
of it runs.

Planes (``plane``):

* ``"packed"`` — the full mixed-resolution wire format: sign, hi and
  code uint32 planes (DESIGN.md §9), encoded by K1–K2 and reduced by
  K3 without a dense reconstruction;
* ``"signplane"`` — the dense reconstruction's 1-bit sign plane packed
  by K4 and reduced by K5 with per-user scales ``w_g * dw_q_g / 2``,
  plus a dense weighted correction on the high-resolution support;
* ``"dense"`` — the dense reconstructions reduced by one weighted sum.

Streaming knobs (DESIGN.md §12–13):

* ``cohort_size`` — the engine trains, encodes and folds the K users in
  cohorts of C on the packed plane, so no ``[K, d]`` buffer exists;
* ``clusters`` — AP-cluster groups, each a partial ``[d]`` aggregate,
  combined in fixed cluster order (needs ``cohort_size``);
* ``budget`` — a per-layer :class:`repro_torch.core.quantize.LayerBudget`;
  a uniform one is ``None`` (:attr:`WirePath.effective_budget`).

The plane checksum is not ported yet and raises
:class:`NotImplementedError`.

``lowering``:

* ``"auto"`` — by the tensor's device: the CUDA kernels for a CUDA
  tensor, the plain PyTorch versions (``kernels/ref.py``) for a CPU
  tensor;
* ``"kernel"`` — the CUDA kernels; a CPU tensor raises;
* ``"reference"`` — the plain versions on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

PLANES = ("dense", "signplane", "packed")
LOWERINGS = ("auto", "kernel", "reference")

# The packed wire format counts high-res entries (dbar) and folds the
# weighted dequant in f32 accumulators: exact only while every integer
# involved stays below 2**24 (f32 mantissa).
PACKED_DIM_LIMIT = 2 ** 24


def check_packed_dim(d: int, *, where: str = "the packed wire plane"
                     ) -> None:
    """Raise unless ``d`` is exactly countable in the f32 wire headers."""
    if d >= PACKED_DIM_LIMIT:
        raise ValueError(
            f"{where} requires d < 2**24 (got d={d}): the dbar count and "
            "weighted dequant accumulate in f32, which is exact only below "
            "2**24.")


@dataclasses.dataclass(frozen=True)
class WirePath:
    """One wire-path spec (see the module docstring)."""
    plane: str = "packed"
    lowering: str = "auto"
    cohort_size: Optional[int] = None
    clusters: int = 1
    budget: Optional[object] = None
    checksum: bool = False

    def __post_init__(self):
        if self.plane not in PLANES:
            raise ValueError(f"unknown wire plane {self.plane!r}; "
                             f"have {PLANES}")
        if self.lowering not in LOWERINGS:
            raise ValueError(f"unknown wire lowering {self.lowering!r}; "
                             f"have {LOWERINGS}")
        # the JAX spec's rules, before the unported checksum
        if self.cohort_size is not None and self.cohort_size < 1:
            raise ValueError(
                f"cohort_size must be >= 1 or None, got {self.cohort_size}")
        if self.clusters < 1:
            raise ValueError(f"clusters must be >= 1, got {self.clusters}")
        if self.cohort_size is not None and self.plane != "packed":
            raise ValueError(
                "cohort streaming folds packed wire planes; use "
                f"plane='packed' (got plane={self.plane!r})")
        if self.clusters > 1 and self.cohort_size is None:
            raise ValueError(
                "clusters > 1 partially aggregates cohort streams; set "
                "cohort_size as well")
        if self.budget is not None and not (
                hasattr(self.budget, "segments_for")
                and hasattr(self.budget, "is_uniform")):
            raise ValueError(
                "budget must be a repro_torch.core.quantize.LayerBudget "
                f"(got {type(self.budget).__name__})")
        if self.checksum and self.plane != "packed":
            raise ValueError(
                "checksum folds the packed uint32 wire planes; use "
                f"plane='packed' (got plane={self.plane!r})")
        if self.budget is not None and not self.budget.is_uniform:
            if self.plane == "signplane":
                raise ValueError(
                    "per-layer budgets are not supported on the signplane "
                    "plane; use plane='packed' or plane='dense'")
            if self.streaming or self.clusters > 1:
                raise ValueError(
                    "per-layer budgets do not compose with cohort "
                    "streaming or AP clusters yet; drop cohort_size/"
                    "clusters or use LayerBudget.uniform()")
        if self.checksum:
            raise NotImplementedError(
                "WirePath.checksum is not ported to repro_torch yet")

    @property
    def effective_budget(self):
        """The budget when it changes anything, else None: a uniform
        budget keeps the global path bit for bit."""
        if self.budget is not None and not self.budget.is_uniform:
            return self.budget
        return None

    @property
    def streaming(self) -> bool:
        """True when the engine folds the users in cohorts."""
        return self.cohort_size is not None

    def use_kernel(self, t: torch.Tensor) -> bool:
        """True when the op on tensor ``t`` runs the CUDA kernels (K1–K3
        on the packed plane, K4–K5 on the signplane plane)."""
        if self.lowering == "reference":
            return False
        if self.lowering == "kernel" and t.device.type != "cuda":
            raise ValueError("lowering='kernel' needs CUDA tensors, got "
                             f"a tensor on {t.device}")
        return t.device.type == "cuda"

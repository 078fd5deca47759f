"""repro_torch.phy — the batched physical layer for the sweep driver.

``repro.phy`` on the port: the CFmMIMO channel and power-control stack
over a leading batch axis of (realization x sweep-cell x round):

* :mod:`channel` — the eq. (5) coefficient bundle as a
  ``ChannelBatch`` of tensors; batched realization drawing;
* :mod:`solvers` — bisection (a projected linear solve for scipy's LP
  feasibility), Dinkelbach and max-sum-rate over fixed iteration
  counts, all mask-aware for user churn;
* :mod:`bitalloc` — batched rate-aware bit allocation.

Plain PyTorch (no kernel of its own: the JAX package runs these as
XLA-compiled jnp).  The numpy implementations in ``core/channel`` and
``core/power`` stay the references; ``tests/test_torch_phy.py`` holds
the tolerances of DESIGN.md section 7.
"""
from .bitalloc import (equalizing_target_latency_batch,
                       rate_aware_fractions_batch)
from .channel import (ChannelBatch, bundle_from_realization_grid,
                      bundle_from_realizations, compute_bundle,
                      make_channel_batch, uplink_latency_batch)
from .solvers import (BatchedPowerSolution, batched_solver,
                      bisection_solve, dinkelbach_solve,
                      eta_upper_bound_batch, maxsum_solve, maxsum_starts)

__all__ = [
    "BatchedPowerSolution", "ChannelBatch", "batched_solver",
    "bisection_solve", "bundle_from_realization_grid",
    "bundle_from_realizations", "compute_bundle",
    "dinkelbach_solve", "equalizing_target_latency_batch",
    "eta_upper_bound_batch", "make_channel_batch", "maxsum_solve",
    "maxsum_starts", "rate_aware_fractions_batch",
    "uplink_latency_batch",
]

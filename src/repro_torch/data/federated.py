"""Federated partitioning: disjoint IID / non-IID (Dirichlet) shards.

The paper distributes the dataset disjointly over K users (rho_j =
|D_j| / |D|) and evaluates IID and non-IID splits.  Non-IID uses the
standard Dirichlet(alpha) label-skew construction.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .synthetic import ImageDataset


def partition_iid(ds: ImageDataset, K: int, seed: int = 0
                  ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    return [np.sort(s) for s in np.array_split(idx, K)]


def partition_dirichlet(ds: ImageDataset, K: int, alpha: float = 0.3,
                        seed: int = 0, min_per_user: int = 8
                        ) -> List[np.ndarray]:
    """Label-skew non-IID split; every user gets >= min_per_user."""
    rng = np.random.default_rng(seed)
    while True:
        shards = [[] for _ in range(K)]
        for c in range(ds.n_classes):
            idx_c = np.flatnonzero(ds.y == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(K, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for u, part in enumerate(np.split(idx_c, cuts)):
                shards[u].extend(part.tolist())
        if min(len(s) for s in shards) >= min_per_user:
            return [np.sort(np.asarray(s)) for s in shards]
        seed += 1
        rng = np.random.default_rng(seed)


def partition_powerlaw(ds: ImageDataset, K: int, exponent: float = 1.3,
                       seed: int = 0, min_per_user: int = 8
                       ) -> List[np.ndarray]:
    """Heterogeneous-size IID split: user j's shard size proportional to
    ``(j+1)^-exponent`` (Zipf-like device heterogeneity, as in the
    energy/latency FL-over-CFmMIMO literature), floored at
    ``min_per_user``.  Label distribution stays IID; only |D_j| varies,
    so rho_j = |D_j|/|D| and the per-user computation loads spread."""
    if len(ds) < K:
        raise ValueError(
            f"partition_powerlaw needs >= 1 sample per user: dataset has "
            f"{len(ds)} samples for K={K} users")
    rng = np.random.default_rng(seed)
    raw = (1.0 + np.arange(K)) ** (-float(exponent))
    sizes = np.maximum((raw / raw.sum() * len(ds)).astype(int),
                       min_per_user)
    # trim the largest shards until the sizes fit the dataset again;
    # len(ds) >= K guarantees the argmax shard holds >= 2 samples
    # whenever trimming is still needed, so no shard ever reaches 0
    while sizes.sum() > len(ds):
        sizes[int(np.argmax(sizes))] -= 1
    assert sizes.min() >= 1, sizes
    idx = rng.permutation(len(ds))
    cuts = np.cumsum(sizes)[:-1]
    return [np.sort(s) for s in np.split(idx[:sizes.sum()], cuts)]


def validate_shards(shards: List[np.ndarray]) -> None:
    """Refuse empty user shards loudly.  An empty shard used to surface
    as ``take=0`` reshape failures deep inside the engine's first jitted
    round; every partitioner above guarantees >= 1 sample per user, so
    hitting this means hand-built shards or a partitioner bug."""
    for j, s in enumerate(shards):
        if len(s) == 0:
            raise ValueError(
                f"user {j} has an empty data shard (0 of {len(shards)} "
                "shards' samples); every user must hold >= 1 sample — "
                "check the partitioner arguments (K vs dataset size)")


def user_fractions(shards: List[np.ndarray]) -> np.ndarray:
    """rho_j = |D_j| / |D|."""
    sizes = np.array([len(s) for s in shards], np.float64)
    return sizes / sizes.sum()


"""Named simulation scenarios for the vectorized engine.

A Scenario is a declarative bundle of (dataset, partition, FL
hyper-parameters, CFmMIMO network shape, engine behaviour) that
``build_problem`` turns into concrete engine inputs.  The dataclass is
``repro.sim.scenarios.Scenario`` field for field, so one scenario means
the same run in both packages; the registry holds the entries the
port runs (the paper's Tables II and III, ``churn-0.7``,
``monte-carlo-channel``, ``monte-carlo-replicated``, ``hetero-data``,
``signplane-wire``, ``fused-wire``, ``cohort-wire``,
``cohort-hierarchy``, ``layer-budget-wire``, ``async-q50``,
``async-churn`` and ``async-sync-reduction``), each as the JAX package
registers it, plus ``async-q50-wire``, ``async-q50`` on the packed
plane (so that an async round runs K1–K3).  :func:`async_scenarios`
makes the staleness sweep axes.

``aggregation`` picks the wire plane: ``"dense"`` (``paper-table3``'s
default), ``"signplane"`` and ``"wire"`` (the packed plane).
``cohort_size`` and ``clusters`` stream the users (DESIGN.md §12),
``budget`` sets per-layer budgets (§13), ``async_mode`` with a deadline
runs async rounds (§11), and ``replicates`` > 1 sends a scenario to the
batched driver's replicate axis.  The registry transformers are not
ported and raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.paper_cnn import (CIFAR10, CIFAR100, FASHION,
                                           PaperCNNConfig)
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.core.quantize import LayerBudget
from repro_torch.data import (make_image_classification, partition_dirichlet,
                              partition_iid, partition_powerlaw)
from repro_torch.kernels import WirePath

from .engine import EngineConfig, StalenessConfig

_PLANES = {"dense": "dense", "signplane": "signplane", "wire": "packed"}

_DATASETS: Dict[str, Tuple[PaperCNNConfig, int]] = {
    "cifar10-syn": (CIFAR10, 10),
    "cifar100-syn": (CIFAR100, 100),
    "fashion-syn": (FASHION, 10),
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    # model axis: "paper-cnn" (scn.dataset picks the CNN geometry); the
    # registry transformers are not ported
    model: str = "paper-cnn"
    seq_len: int = 32                    # LM window length (model != cnn)
    # per-layer mixed-resolution budget (a LayerBudget) on
    # WirePath.budget; None or a uniform budget keeps the global path
    budget: Optional[object] = None
    # data
    dataset: str = "cifar10-syn"
    n_train: int = 8000
    n_test: int = 1600
    partition: str = "iid"               # iid | dirichlet | powerlaw
    dirichlet_alpha: float = 0.3
    powerlaw_exp: float = 1.3
    # FL (paper Table I / §IV defaults)
    K: int = 20
    T: int = 100
    L: int = 5
    batch_size: int = 48
    lr: float = 0.01
    eval_every: Optional[int] = None     # None => max(1, T // 5)
    latency_budget_s: Optional[float] = None
    # CFmMIMO network (None M => no channel/power simulation)
    M: Optional[int] = 16
    N: int = 4
    # engine behaviour: churn and Monte-Carlo channel redraws
    participation: float = 1.0
    redraw_channel_every: int = 0
    # wire-path plane: "dense" | "signplane" | "wire" (the packed plane)
    aggregation: str = "dense"
    fused: bool = True               # production sweeps run fully fused
    # streaming cohorts (the packed plane: train, encode and fold this
    # many users at a time) and AP clusters (needs cohort_size)
    cohort_size: Optional[int] = None
    clusters: int = 1
    seed: int = 0
    # Monte-Carlo replicates (run_grid_batched) and asynchronous rounds:
    # async_mode with neither deadline set is the sync reduction (the
    # lockstep path); deadline_quantile closes each round at that
    # quantile of the pending completion times
    replicates: int = 1
    async_mode: bool = False
    deadline_s: Optional[float] = None
    deadline_quantile: Optional[float] = None
    staleness_alpha: float = 0.0
    max_staleness: int = 2

    def scaled(self, quick: bool = True) -> "Scenario":
        """Quick-mode variant: reduced K/T/data for CPU CI runs."""
        if not quick:
            return self
        return dataclasses.replace(
            self, K=min(self.K, 8), T=min(self.T, 10),
            n_train=min(self.n_train, 2000), n_test=min(self.n_test, 400),
            batch_size=min(self.batch_size, 32))

    @property
    def effective_eval_every(self) -> int:
        return self.eval_every if self.eval_every is not None \
            else max(1, self.T // 5)

    def engine_config(self) -> EngineConfig:
        """The engine configuration this scenario asks for."""
        if self.aggregation not in _PLANES:
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             f"have {tuple(_PLANES)}")
        wire = WirePath(plane=_PLANES[self.aggregation],
                        cohort_size=self.cohort_size,
                        clusters=self.clusters, budget=self.budget)
        return EngineConfig(wire=wire,
                            fused=self.fused,
                            participation=self.participation,
                            redraw_channel_every=self.redraw_channel_every,
                            channel_seed=self.seed,
                            async_mode=self.async_mode,
                            staleness=StalenessConfig(
                                deadline_s=self.deadline_s,
                                deadline_quantile=self.deadline_quantile,
                                alpha=self.staleness_alpha,
                                max_staleness=self.max_staleness))

    @property
    def async_active(self) -> bool:
        """``EngineConfig.async_active`` before any engine exists: the
        batched driver gives async cells a track each."""
        return self.engine_config().async_active


def build_problem(scn: Scenario):
    """(train, test, shards, model, chan) for a scenario, ``model``
    being the scenario's :class:`PaperCNNConfig`.  numpy throughout:
    the same scenario gives the same arrays as
    ``repro.sim.scenarios.build_problem``."""
    if scn.model != "paper-cnn":
        raise NotImplementedError(
            f"model={scn.model!r}: the registry transformers are not "
            "ported to repro_torch yet")
    if scn.dataset not in _DATASETS:
        raise KeyError(f"unknown dataset {scn.dataset!r}; "
                       f"have {list(_DATASETS)}")
    cnn_cfg, n_classes = _DATASETS[scn.dataset]
    full = make_image_classification(
        n_samples=scn.n_train + scn.n_test, hw=cnn_cfg.input_hw,
        channels=cnn_cfg.channels, n_classes=n_classes, seed=scn.seed)
    train = dataclasses.replace(full, x=full.x[:scn.n_train],
                                y=full.y[:scn.n_train])
    test = dataclasses.replace(full, x=full.x[scn.n_train:],
                               y=full.y[scn.n_train:])

    if scn.partition == "iid":
        shards = partition_iid(train, scn.K, seed=scn.seed)
    elif scn.partition == "dirichlet":
        shards = partition_dirichlet(train, scn.K,
                                     alpha=scn.dirichlet_alpha,
                                     seed=scn.seed)
    elif scn.partition == "powerlaw":
        shards = partition_powerlaw(train, scn.K, exponent=scn.powerlaw_exp,
                                    seed=scn.seed)
    else:
        raise KeyError(f"unknown partition {scn.partition!r}")

    chan = None
    if scn.M is not None:
        chan = make_channel(CFmMIMOConfig(M=scn.M, N=scn.N, K=scn.K),
                            seed=scn.seed)
    return train, test, shards, cnn_cfg, chan


# ----------------------------------------------------------- registry
SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(scn: Scenario) -> Scenario:
    if scn.name in SCENARIOS:
        raise KeyError(f"scenario {scn.name!r} already registered")
    SCENARIOS[scn.name] = scn
    return scn


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def async_scenarios(alphas=(0.0, 1.0), quantiles=(0.5, 0.9),
                    depths=(1, 2), base: Optional[Scenario] = None
                    ) -> List[Scenario]:
    """The staleness sweep axes: alpha x deadline-quantile x buffer-depth
    variants of ``base`` (default: ``async-q50``), unregistered — pass
    them to ``run_grid`` or ``run_grid_batched`` as they are."""
    base = base or SCENARIOS.get("async-q50") or Scenario(
        name="async-base", description="async sweep point",
        K=20, T=40, async_mode=True, deadline_quantile=0.5)
    out = []
    for alpha in alphas:
        for q in quantiles:
            for depth in depths:
                out.append(dataclasses.replace(
                    base, name=f"async-a{alpha:g}-q{q:g}-d{depth}",
                    description=(f"async sweep point alpha={alpha:g}, "
                                 f"deadline quantile {q:g}, buffer "
                                 f"depth {depth}"),
                    async_mode=True, deadline_s=None,
                    deadline_quantile=q, staleness_alpha=alpha,
                    max_staleness=depth))
    return out


register_scenario(Scenario(
    name="paper-table2",
    description="Table II operating point: K=20, L=5, IID/convergence "
                "(no latency simulation)",
    M=None, T=100, K=20, batch_size=48))

register_scenario(Scenario(
    name="paper-table2-noniid",
    description="Table II non-IID: Dirichlet(0.3) label skew",
    M=None, T=100, K=20, partition="dirichlet", batch_size=48))

register_scenario(Scenario(
    name="paper-table3",
    description="Table III operating point: K=40 non-IID over the "
                "CFmMIMO uplink with a total-latency budget",
    K=40, T=60, partition="dirichlet", batch_size=32))

register_scenario(Scenario(
    name="churn-0.7",
    description="user churn: every user independently participates in "
                "a round w.p. 0.7; aggregation weights renormalized",
    K=20, T=40, partition="dirichlet", participation=0.7))

register_scenario(Scenario(
    name="monte-carlo-channel",
    description="Monte-Carlo fading geometry: fresh large-scale "
                "realization every round (Vu et al. style averaging)",
    K=20, T=40, redraw_channel_every=1))

register_scenario(Scenario(
    name="monte-carlo-replicated",
    description="Monte-Carlo replicate axis: 8 independent trajectories "
                "(distinct channel realizations + data/churn RNG "
                "streams) vmapped through one train step per round; "
                "summaries report mean +- ci95",
    K=20, T=40, replicates=8))

register_scenario(Scenario(
    name="hetero-data",
    description="Zipf(1.3) shard sizes: heterogeneous per-user data "
                "loads (Mahmoudi et al. style device heterogeneity)",
    K=20, T=40, partition="powerlaw"))

register_scenario(Scenario(
    name="signplane-wire",
    description="paper default but aggregating through the "
                "signpack/sign_dequant_reduce wire format (K4, K5)",
    M=None, K=20, T=40, aggregation="signplane"))

register_scenario(Scenario(
    name="fused-wire",
    description="paper default on the fully fused quantize-to-wire "
                "path: mixed-res encode, packed planes and weighted "
                "dequant-reduce all in the wire kernels K1-K3",
    M=None, K=20, T=40, aggregation="wire"))

register_scenario(Scenario(
    name="cohort-wire",
    description="fused-wire with the user axis streamed in cohorts of "
                "8: each cohort trains and packs 8 users and folds into "
                "the carried [d] accumulator, so the dense [K, d] "
                "gradient stack never exists (DESIGN.md section 12)",
    M=None, K=20, T=40, aggregation="wire", cohort_size=8))

register_scenario(Scenario(
    name="cohort-hierarchy",
    description="two-level cell-free hierarchy: 4 AP-cluster groups "
                "each aggregate their users' packed planes on device "
                "(cohorts of 8), partial [d] aggregates combined in "
                "cluster order",
    M=None, K=20, T=40, aggregation="wire", cohort_size=8, clusters=4))

register_scenario(Scenario(
    name="async-q50",
    description="asynchronous rounds: each round closes at the median "
                "pending completion time; misses wait in a depth-2 "
                "staleness buffer with (1+s)^-0.5 down-weighting",
    K=20, T=40, async_mode=True, deadline_quantile=0.5,
    staleness_alpha=0.5, max_staleness=2))

register_scenario(Scenario(
    name="async-churn",
    description="async rounds under user churn (participation 0.7): "
                "users dropping mid-upload are evicted from the "
                "staleness buffer, never aggregated",
    K=20, T=40, async_mode=True, deadline_quantile=0.5,
    staleness_alpha=1.0, max_staleness=2, participation=0.7,
    partition="dirichlet"))

register_scenario(Scenario(
    name="layer-budget-wire",
    description="paper default under a per-layer budget: norm-like "
                "leaves keep a fine grid (b=12, lambda 0.1), matmul "
                "leaves a coarse one (b=6, lambda 0.3); payload bits "
                "are the exact per-segment sum (DESIGN.md section 13)",
    M=None, K=20, T=40, aggregation="wire",
    budget=LayerBudget.by_group(norm=(0.1, 12), matmul=(0.3, 6))))

register_scenario(Scenario(
    name="async-sync-reduction",
    description="async_mode=True with no deadline — the sync reduction: "
                "runs the lockstep engine bit for bit",
    K=20, T=40, async_mode=True))

# the port's own variant: async-q50 on the packed plane, where an async
# round's aggregate is one K3 over the fresh and the buffered planes
register_scenario(dataclasses.replace(
    SCENARIOS["async-q50"], name="async-q50-wire",
    description="async-q50 on the packed wire plane: the fresh uploads "
                "encoded by K1-K2, the arrivals and the buffer folded by "
                "one K3 over 2K slots",
    aggregation="wire"))

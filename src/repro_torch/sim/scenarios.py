"""Named simulation scenarios for the vectorized engine.

A Scenario is a declarative bundle of (dataset, partition, FL
hyper-parameters, CFmMIMO network shape, engine behaviour) that
``build_problem`` turns into concrete engine inputs.  The dataclass is
``repro.sim.scenarios.Scenario`` field for field, so one scenario means
the same run in both packages; the registry holds the entries the
port runs (the paper's Tables II and III, ``churn-0.7``,
``monte-carlo-channel``, ``monte-carlo-replicated``, ``hetero-data``,
``signplane-wire`` and ``fused-wire``), each as the JAX package
registers it.

``aggregation`` picks the wire plane: ``"dense"`` (``paper-table3``'s
default), ``"signplane"`` and ``"wire"`` (the packed plane).
``replicates`` > 1 sends a scenario to the batched driver's replicate
axis.  Cohorts, clusters, budgets, async rounds and registry
transformers are not ported and raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.paper_cnn import (CIFAR10, CIFAR100, FASHION,
                                           PaperCNNConfig)
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.data import (make_image_classification, partition_dirichlet,
                              partition_iid, partition_powerlaw)
from repro_torch.kernels import WirePath

from .engine import EngineConfig

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
    # per-layer mixed-resolution budget (not ported)
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
    # streaming cohorts and AP clusters (not ported)
    cohort_size: Optional[int] = None
    clusters: int = 1
    seed: int = 0
    # Monte-Carlo replicates (run_grid_batched) and asynchronous rounds
    # (not ported)
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
        """The engine configuration this scenario asks for; raises
        :class:`NotImplementedError` for what the port does not run."""
        unported = {"cohort_size": (self.cohort_size, None),
                    "clusters": (self.clusters, 1),
                    "budget": (self.budget, None)}
        for name, (value, off) in unported.items():
            if value != off:
                raise NotImplementedError(
                    f"Scenario.{name}={value!r} is not ported to "
                    "repro_torch yet")
        if self.aggregation not in _PLANES:
            raise ValueError(f"unknown aggregation {self.aggregation!r}; "
                             f"have {tuple(_PLANES)}")
        return EngineConfig(wire=WirePath(plane=_PLANES[self.aggregation]),
                            fused=self.fused,
                            participation=self.participation,
                            redraw_channel_every=self.redraw_channel_every,
                            channel_seed=self.seed,
                            async_mode=self.async_mode)


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

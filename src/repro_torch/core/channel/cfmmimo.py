"""CFmMIMO uplink model — §II-B of the paper (eq. 4-5) + Table I.

M access points with N antennas each serve K single-antenna FL users on
the same time/frequency resource.  Independent Rayleigh fading with
large-scale coefficients beta_m^j from a log-distance pathloss model on
a wrap-around square; tau_p-length pilots with greedy assignment (users
beyond tau_p reuse the pilot with least co-pilot interference, in the
spirit of the algorithm in [Demir & Björnson 2021]); MR combining.

Everything here is closed-form in the large-scale coefficients, so the
whole channel layer is deterministic given user/AP positions: the
achievable rate eq. (4) needs only the coefficient bundle
(A_bar, B_bar, B_tilde, I_M) of eq. (5), which we precompute once per
realization and hand to the power-control solvers.

numpy (not torch): this is the simulation/control-plane layer that
feeds scipy's LP; K <= 40, M <= 64 — negligible compute.  A copy of
``repro.core.channel.cfmmimo``: the same seed gives the same
realization in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CFmMIMOConfig:
    """Table I parameters."""
    M: int = 16                    # number of APs
    N: int = 4                     # antennas per AP
    K: int = 20                    # FL users
    bandwidth_hz: float = 20e6     # B
    area_m: float = 1000.0         # wrap-around square side
    pathloss_exp: float = 3.67     # alpha_p
    tau_c: int = 200               # coherence block length
    tau_p: int = 10                # pilot length
    p_max_w: float = 0.1           # p^u = 100 mW
    noise_dbm: float = -94.0       # sigma^2 (incl. 7 dB noise figure)
    ref_pathloss_db: float = -30.5 # pathloss at 1 m

    @property
    def noise_w(self) -> float:
        return 10 ** (self.noise_dbm / 10) / 1000.0

    @property
    def pre_log(self) -> float:
        """B_tau = B (1 - tau_p / tau_c)."""
        return self.bandwidth_hz * (1.0 - self.tau_p / self.tau_c)


@dataclasses.dataclass(frozen=True)
class ChannelRealization:
    """Large-scale realization + the eq. (5) coefficient bundle."""
    cfg: CFmMIMOConfig
    beta: np.ndarray        # [M, K] large-scale fading
    pilot: np.ndarray       # [K] pilot index per user
    gamma: np.ndarray       # [M, K] estimation quality, eq. (5)
    A_bar: np.ndarray       # [K]
    B_bar: np.ndarray       # [K]
    B_tilde: np.ndarray     # [K, K]  (row j, col j'), diag unused
    I_M: np.ndarray         # [K]

    def sinr(self, p: np.ndarray) -> np.ndarray:
        """eq. (5): SINR_j(p) for power-control vector p in [0,1]^K."""
        p = np.asarray(p, dtype=np.float64)
        num = self.A_bar * p
        cross = self.B_tilde @ p - np.diag(self.B_tilde) * p
        den = self.B_bar * p + cross + self.I_M
        return num / den

    def rates(self, p: np.ndarray) -> np.ndarray:
        """eq. (4): achievable uplink rate (bit/s) per user."""
        return self.cfg.pre_log * np.log2(1.0 + self.sinr(p))


def _wrap_dist(a: np.ndarray, b: np.ndarray, side: float) -> np.ndarray:
    """Torus (wrap-around) distances between point sets [.,2] x [.,2]."""
    diff = np.abs(a[:, None, :] - b[None, :, :])
    diff = np.minimum(diff, side - diff)
    return np.sqrt(np.sum(diff ** 2, axis=-1))


def _greedy_pilot_assignment(beta: np.ndarray, tau_p: int) -> np.ndarray:
    """First tau_p users get orthogonal pilots; each later user takes the
    pilot minimizing co-pilot interference at its strongest AP."""
    M, K = beta.shape
    pilot = np.zeros(K, dtype=np.int64)
    for j in range(K):
        if j < tau_p:
            pilot[j] = j
            continue
        m_star = int(np.argmax(beta[:, j]))
        cost = np.array([
            beta[m_star, np.flatnonzero(pilot[:j] == t)].sum()
            for t in range(tau_p)])
        pilot[j] = int(np.argmin(cost))
    return pilot


def _draw_ap_positions(cfg: CFmMIMOConfig, rng: np.random.Generator
                       ) -> np.ndarray:
    """Regular grid of APs (common CFmMIMO deployment), jittered."""
    side = cfg.area_m
    g = int(np.ceil(np.sqrt(cfg.M)))
    xs, ys = np.meshgrid(np.arange(g), np.arange(g))
    pts = (np.stack([xs.ravel(), ys.ravel()], -1)[: cfg.M] + 0.5)
    ap_positions = pts * (side / g) + rng.uniform(-20, 20, (cfg.M, 2))
    return np.mod(ap_positions, side)


def draw_positions(cfg: CFmMIMOConfig, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(ap_positions [M,2], user_positions [K,2]) — the exact RNG stream
    ``make_channel`` consumes when drawing both."""
    rng = np.random.default_rng(seed)
    ap_positions = _draw_ap_positions(cfg, rng)
    user_positions = rng.uniform(0, cfg.area_m, (cfg.K, 2))
    return ap_positions, user_positions


def large_scale_fading(cfg: CFmMIMOConfig, ap_positions: np.ndarray,
                       user_positions: np.ndarray) -> np.ndarray:
    """beta [M, K] from the log-distance pathloss model on the torus."""
    dist = np.maximum(_wrap_dist(ap_positions, user_positions, cfg.area_m),
                      1.0)
    pl_db = cfg.ref_pathloss_db - 10.0 * cfg.pathloss_exp * np.log10(dist)
    return 10 ** (pl_db / 10)                      # [M, K]


def make_channel(cfg: CFmMIMOConfig, seed: int = 0,
                 ap_positions: Optional[np.ndarray] = None,
                 user_positions: Optional[np.ndarray] = None
                 ) -> ChannelRealization:
    """Draw positions, compute beta, assign pilots, build eq. (5) terms.

    RNG-stream contract: one default_rng(seed) stream, consumed only
    for the positions NOT supplied — passing ap_positions explicitly
    leaves the user draw as the stream's first consumption, exactly as
    before draw_positions was factored out.
    """
    rng = np.random.default_rng(seed)
    if ap_positions is None:
        ap_positions = _draw_ap_positions(cfg, rng)
    if user_positions is None:
        user_positions = rng.uniform(0, cfg.area_m, (cfg.K, 2))

    beta = large_scale_fading(cfg, ap_positions, user_positions)
    pilot = _greedy_pilot_assignment(beta, cfg.tau_p)
    copilot = (pilot[:, None] == pilot[None, :]).astype(np.float64)  # [K,K]

    sigma2 = cfg.noise_w
    p_p = cfg.tau_p * cfg.p_max_w                  # pilot energy tau_p p^u

    # gamma_m^j, eq. (5): p_p beta^2 / (p_p sum_j' beta_m^j' |phi'^H phi|^2
    #                                   + sigma^2)
    denom = p_p * (beta @ copilot) + sigma2        # [M, K]
    gamma = p_p * beta ** 2 / denom                # [M, K]

    N = float(cfg.N)
    # REPRO NOTE: eq. (5) prints A_bar_j = (sum_m N gamma_m^j) without a
    # square, but the MR coherent beamforming gain in the cited
    # [25, Th. 2] is (sum_m N gamma_m^j)^2 — matching the squared form of
    # the coherent pilot-contamination term in B_tilde.  Without the
    # square the SINR is dimensionally inconsistent (gives ~1e7 SINRs).
    # We implement the [25, Th. 2]-consistent squared numerator.
    A_bar = (N * gamma.sum(axis=0)) ** 2           # [K]
    B_bar = N * (gamma * beta).sum(axis=0)         # [K]
    I_M = N * sigma2 * gamma.sum(axis=0) / cfg.p_max_w

    # B_tilde[j, j'] = sum_m N gamma_m^j beta_m^j'
    #                + |phi_j^H phi_j'|^2 (sum_m N gamma_m^j beta'/beta)^2
    first = N * np.einsum("mj,mk->jk", gamma, beta)
    ratio = np.einsum("mj,mj,mk->jk", gamma, 1.0 / beta, beta) * N
    B_tilde = first + copilot * ratio ** 2
    np.fill_diagonal(B_tilde, 0.0)                 # j' != j sum only

    return ChannelRealization(cfg=cfg, beta=beta, pilot=pilot, gamma=gamma,
                              A_bar=A_bar, B_bar=B_bar, B_tilde=B_tilde,
                              I_M=I_M)


def uplink_latency(bits: np.ndarray, rates: np.ndarray) -> np.ndarray:
    """eq. (12): per-user uplink latency ell_t^j = b_t^j / R_t^j."""
    return np.asarray(bits, np.float64) / np.maximum(rates, 1e-9)


def computation_latency(L: int, dataset_size: int, K: int,
                        cycles_per_sample: float = 1e6,
                        cycles_per_sec: float = 20e9) -> float:
    """Max local computation time ell_c = L |D| a_i / (K nu_i) [27].

    REPRO NOTE: the paper prints nu_i = 20 cycles/s, which would make a
    single round take ~1e9 seconds and is inconsistent with its own 3 s
    total-latency budget (Table III); 20 Gcycles/s (a ~2 GHz, 10-wide
    device) reproduces the paper's regime where uplink latency and
    computation are comparable.  Documented in DESIGN.md §4b.
    """
    return L * dataset_size * cycles_per_sample / (K * cycles_per_sec)

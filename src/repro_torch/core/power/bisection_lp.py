"""The paper's power control: bisection over eta + LP feasibility (§III).

Problem (14): maximize eta s.t.  0 <= p <= 1  and for every user j

    (A_bar_j - theta_j B_bar_j) p_j - theta_j sum_{j'!=j} Btilde_j^{j'} p_j'
        >= theta_j I_M^j,          theta_j = 2^(eta b_j / B_tau) - 1.

For fixed eta the constraints are linear in p, so feasibility is an LP;
bisection over eta converges to the global optimum within eps_B
(Algorithm 1, lines 13-23).  We recover the power vector of the last
feasible eta.  scipy.optimize.linprog (HiGHS) solves the feasibility
program with objective min sum(p) — any feasible point works; minimum
total power is a natural tie-break and matches how such LPs are run in
practice.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linprog

from ..channel.cfmmimo import ChannelRealization
from .base import PowerController, PowerSolution


def _feasible_powers(chan: ChannelRealization, theta: np.ndarray):
    """LP feasibility of (14c) for fixed theta; returns p or None."""
    K = theta.shape[0]
    # constraint rows: -(A_j - th_j B_j) p_j + th_j sum_{j'} Bt[j,j'] p_j'
    #                  <= -th_j I_M_j
    # Rows are normalized by th_j * I_M_j (RHS = -1): the raw coefficients
    # are O(1e-12) — far below the LP solver's absolute feasibility
    # tolerance, which would make every theta look "feasible".
    A_ub = theta[:, None] * chan.B_tilde.copy()
    diag = -(chan.A_bar - theta * chan.B_bar)
    A_ub[np.arange(K), np.arange(K)] = diag
    scale = theta * chan.I_M
    if np.any(scale <= 0) or not np.all(np.isfinite(A_ub)):
        return None
    A_ub = A_ub / scale[:, None]
    b_ub = -np.ones(K)
    res = linprog(c=np.ones(K), A_ub=A_ub, b_ub=b_ub,
                  bounds=[(0.0, 1.0)] * K, method="highs")
    return res.x if res.status == 0 else None


def eta_upper_bound(chan: ChannelRealization, bits: np.ndarray) -> float:
    """Upper bound on min_j rate-per-bit: every user at full power with
    zero interference — the min over users bounds the achievable min."""
    sinr_max = chan.A_bar / (chan.B_bar + chan.I_M)
    rates = chan.cfg.pre_log * np.log2(1.0 + sinr_max)
    return float(np.min(rates / np.asarray(bits, np.float64)))


class BisectionLPPowerControl(PowerController):
    """Algorithm 1's min-max-latency power control (our scheme)."""

    name = "bisection-lp"

    def __init__(self, eps_rel: float = 1e-4, max_iters: int = 60):
        self.eps_rel = float(eps_rel)
        self.max_iters = int(max_iters)

    def solve(self, chan: ChannelRealization, bits: np.ndarray
              ) -> PowerSolution:
        bits = np.asarray(bits, np.float64)
        B_tau = chan.cfg.pre_log
        lo, hi = 0.0, eta_upper_bound(chan, bits)
        eps = self.eps_rel * hi
        best_p, best_eta, iters = np.ones(chan.cfg.K), 0.0, 0
        while hi - lo > eps and iters < self.max_iters:
            iters += 1
            mid = 0.5 * (lo + hi)
            expo = mid * bits / B_tau
            if np.max(expo) > 500.0:      # 2^500: numerically infeasible
                hi = mid
                continue
            theta = np.power(2.0, expo) - 1.0
            p = _feasible_powers(chan, theta)
            if p is not None:
                lo, best_p, best_eta = mid, p, mid
            else:
                hi = mid
        return self._finish(chan, bits, best_p, eta=best_eta,
                            bisection_iters=iters)

"""Batched power-control solvers (paper section III-IV) on torch tensors.

``repro.phy.solvers`` on the port: the three ``core/power`` controllers
over a leading batch of (realization x sweep-cell x round) problems,
so a whole grid's power control is one batched call a round instead of
one host scipy/numpy solve a cell:

* :func:`bisection_solve` — Algorithm 1 (min-max latency).  scipy's LP
  feasibility program is replaced by a direct linear solve: for fixed
  theta the constraint set ``p >= M p + c`` (M >= 0, c > 0) is feasible
  iff the least fixed point ``p* = (I - M)^{-1} c`` exists with
  ``0 <= p* <= 1`` (a nonnegative solution certifies that M's spectral
  radius is < 1, Perron-Frobenius), and p* is the LP's min-sum-power
  optimum — so the batched path takes the reference's bisection
  decisions one for one.  ``torch.linalg.solve_ex`` neither raises nor
  synchronises on a singular system: such a row is infeasible.
* :func:`dinkelbach_solve` — energy-efficiency maximizer; the outer
  update and the early exit ``|f| < tol`` replayed with a per-cell
  done mask over a fixed number of iterations.
* :func:`maxsum_solve` — projected gradient ascent with restarts.

Precision is the bundle's dtype.  ``grad_mode="fd"`` replays the numpy
references' forward-difference gradients step for step (the parity
mode, in float64); ``"auto"`` differentiates with ``torch.func.grad``,
the float32 default, because a 1e-6 forward difference is below the
objective's f32 ulp.  ``None`` picks ``"fd"`` for float64 and
``"auto"`` otherwise.  DESIGN.md section 7 holds the tolerances.

A ``mask`` of 0/1 per user is the engine's sub-channel under churn:
masked users get no power, interfere with nobody, are left out of the
eta bound and the objectives, and never become the straggler.

Each solver takes a :class:`ChannelBatch` with a leading batch axis B,
payloads ``bits [B, K]`` and an optional ``mask [B, K]`` (numpy or
torch, moved to the bundle's dtype and device) and returns a
:class:`BatchedPowerSolution`: ``p [B, K]`` in [0, 1], per-user rates
and completion times (0 where masked) and per-cell solver diagnostics.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import grad as func_grad

from .channel import ChannelBatch, uplink_latency_batch

# the bisection loop asks the device whether any cell still runs once
# every this many iterations (each ask is a host sync on the card); the
# iterations in between are masked no-ops for converged cells, so the
# outputs do not depend on it
BISECTION_SYNC_EVERY = 4


def _resolve_grad_mode(grad_mode: Optional[str], dtype: torch.dtype) -> str:
    if grad_mode is None:
        return "fd" if dtype == torch.float64 else "auto"
    if grad_mode not in ("fd", "auto"):
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    return grad_mode


@dataclasses.dataclass(frozen=True)
class BatchedPowerSolution:
    """Batched counterpart of ``core.power.base.PowerSolution``."""
    p: torch.Tensor              # [B, K] power coefficients in [0, 1]
    rates: torch.Tensor          # [B, K] achieved rates (bit/s); 0 if masked
    latencies: torch.Tensor      # [B, K] uplink latency (s); 0 if masked
    info: Dict[str, torch.Tensor]  # per-cell solver diagnostics [B]

    @property
    def straggler_latency(self) -> torch.Tensor:
        return torch.amax(self.latencies, dim=-1)       # [B]


def _inputs(cb: ChannelBatch, bits, mask):
    """bits and mask in the bundle's dtype and on its device, broadcast
    to one shape (an all-ones mask when none is given)."""
    like = dict(dtype=cb.A_bar.dtype, device=cb.A_bar.device)
    bits = torch.as_tensor(bits, **like)
    if mask is None:
        shape = torch.broadcast_shapes(cb.A_bar.shape, bits.shape)
        mask = torch.ones(shape, **like)
    else:
        mask = torch.as_tensor(mask, **like)
    return bits.expand(mask.shape), mask


def _finish(cb: ChannelBatch, bits, mask, p, info) -> BatchedPowerSolution:
    p = torch.clamp(p, 0.0, 1.0) * mask
    rates = cb.rates(p, mask)
    lat = uplink_latency_batch(bits, rates, mask)
    return BatchedPowerSolution(p=p, rates=rates * mask, latencies=lat,
                                info=info)


def _normalize(cb: ChannelBatch) -> ChannelBatch:
    """Scale each user's coefficient row by 1 / I_M_j.

    SINR_j is invariant under a common scaling of (A_bar_j, B_bar_j,
    B_tilde[j, :], I_M_j), and the raw Table I coefficients sit far
    below 1 (4e-24 to 8e-11 at ``paper-table3``): the f32 backward pass
    squares the SINR denominator into underflow.  Normalized rows are
    O(1)-O(100).  The numpy LP reference normalizes its rows likewise."""
    s = 1.0 / cb.I_M
    return ChannelBatch(A_bar=cb.A_bar * s, B_bar=cb.B_bar * s,
                        B_tilde=cb.B_tilde * s[..., :, None],
                        I_M=torch.ones_like(cb.I_M),
                        pre_log=cb.pre_log, p_max_w=cb.p_max_w)


def _lift(x: torch.Tensor, n: int, keep: int) -> torch.Tensor:
    """``x`` with ``n`` singleton axes inserted before its last ``keep``
    axes."""
    cut = x.dim() - keep
    return x.reshape(x.shape[:cut] + (1,) * n + x.shape[cut:])


def _extra_axes(p: torch.Tensor, ref: torch.Tensor) -> int:
    return p.dim() - ref.dim()


def _sum_rate_obj(cb: ChannelBatch, mask: torch.Tensor
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """sum_j log2(1 + SINR_j) over active users; p [..., E..., K] ->
    [..., E...], where ``...`` are the bundle's batch axes and ``E``
    any number of axes more (restarts, forward-difference points)."""
    def obj(p):
        n = _extra_axes(p, cb.A_bar)
        if n:
            cbe = ChannelBatch(A_bar=_lift(cb.A_bar, n, 1),
                               B_bar=_lift(cb.B_bar, n, 1),
                               B_tilde=_lift(cb.B_tilde, n, 2),
                               I_M=_lift(cb.I_M, n, 1),
                               pre_log=cb.pre_log, p_max_w=cb.p_max_w)
            m = _lift(mask, _extra_axes(p, mask), 1)
        else:
            cbe, m = cb, mask
        return torch.sum(m * torch.log2(1.0 + cbe.sinr(p, m)), dim=-1)
    return obj


def _fd_grad(obj: Callable, p: torch.Tensor, mask: torch.Tensor,
             h: float = 1e-6) -> torch.Tensor:
    """The numpy references' forward difference, replayed:
    q_j = min(1, p_j + h), g_j = (obj(q) - obj(p)) / max(q_j - p_j,
    1e-12), one base evaluation a call.

    The base point is row 0 of the same batched evaluation as the K
    perturbations: where a coordinate is clipped (q_j == p_j) the
    difference must be exactly 0, as in the scalar numpy path, and the
    1e-12 floor would amplify an ulp between two separately computed
    bases into a phantom gradient."""
    K = p.shape[-1]
    eye = torch.eye(K, dtype=torch.bool, device=p.device)
    q = torch.where(eye, torch.clamp(p[..., None, :] + h, max=1.0),
                    p[..., None, :])                 # [..., Kpert, K]
    vals_aug = obj(torch.cat([p[..., None, :], q], dim=-2))
    base, vals = vals_aug[..., 0], vals_aug[..., 1:]  # [...], [..., Kpert]
    qdiag = torch.clamp(p + h, max=1.0)
    g = (vals - base[..., None]) / torch.clamp_min(qdiag - p, 1e-12)
    # a clipped coordinate has difference EXACTLY 0 in the scalar
    # reference; batched rounding is positional, so the zero is
    # structural rather than trusted to val == base bitwise
    g = torch.where(qdiag > p, g, torch.zeros_like(g))
    return g * mask


def _auto_grad(obj: Callable, p: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
    return func_grad(lambda q: torch.sum(obj(q)))(p) * mask


def _grad_fn(grad_mode: str) -> Callable:
    return _fd_grad if grad_mode == "fd" else _auto_grad


# ------------------------------------------------------------ eta bound
def eta_upper_bound_batch(cb: ChannelBatch, bits, mask=None
                          ) -> torch.Tensor:
    """Batched ``core.power.eta_upper_bound``: a per-cell upper bound on
    the min rate-per-bit (full power, zero interference)."""
    bits, mask = _inputs(cb, bits, mask)
    sinr_max = cb.A_bar / (cb.B_bar + cb.I_M)
    rates = cb.pre_log * torch.log2(1.0 + sinr_max)
    per_user = torch.where(mask > 0, rates / bits,
                           torch.full_like(bits, float("inf")))
    return torch.amin(per_user, dim=-1)              # [B]


# --------------------------------------------------------- bisection-LP
def _feasible_point(cb: ChannelBatch, mask, theta, eye):
    """Least fixed point of p = M p + c on the active sub-channel, and
    whether it is feasible: finite (a nonsingular system), inside the
    box, and every active user's SINR target attainable at all
    (A_bar_j - theta_j B_bar_j > 0)."""
    denom = cb.A_bar - theta * cb.B_bar              # [B, K]
    bad = torch.any((mask > 0) & (denom <= 0), dim=-1)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    row = theta / safe * mask                        # [B, K]
    M = row[..., :, None] * cb.B_tilde * mask[..., None, :]
    c = row * cb.I_M                                 # [B, K]
    p_star, info = torch.linalg.solve_ex(eye - M, c[..., None],
                                         check_errors=False)
    p_star = p_star[..., 0]
    finite = torch.all(torch.isfinite(p_star), dim=-1) & (info == 0)
    inbox = torch.all((p_star >= 0.0) & (p_star <= 1.0), dim=-1)
    return p_star, finite & inbox & ~bad


def bisection_solve(cb: ChannelBatch, bits, mask=None,
                    eps_rel: float = 1e-4, max_iters: int = 60
                    ) -> BatchedPowerSolution:
    """Batched Algorithm 1: bisection over eta with the linear-solve
    feasibility oracle (the reference's decisions, the same returned
    min-sum-power vector)."""
    bits, mask = _inputs(cb, bits, mask)
    B_tau = cb.pre_log
    hi = eta_upper_bound_batch(cb, bits, mask)       # [B]
    eps = eps_rel * hi
    lo = torch.zeros_like(hi)
    eye = torch.eye(cb.K, dtype=hi.dtype, device=hi.device)
    best_p = mask.clone()
    best_eta = torch.zeros_like(hi)
    iters = torch.zeros(hi.shape, dtype=torch.int32, device=hi.device)
    neg_inf = torch.full_like(bits, float("-inf"))
    for it in range(max_iters):
        run = (hi - lo > eps) & (iters < max_iters)  # [B]
        if it % BISECTION_SYNC_EVERY == 0 and not bool(run.any()):
            break
        iters = iters + run.to(iters.dtype)
        mid = 0.5 * (lo + hi)
        expo = mid[..., None] * bits / B_tau         # [B, K]
        expo_max = torch.amax(torch.where(mask > 0, expo, neg_inf), dim=-1)
        skip = expo_max > 500.0                      # 2^500: infeasible
        # as the reference writes it: in float32 2^expo overflows to inf
        # past 128, so the cell is infeasible there
        theta = torch.exp2(torch.clamp(expo, max=500.0)) - 1.0
        p_star, ok = _feasible_point(cb, mask, theta, eye)
        feas = run & ok & ~skip
        infeas = run & ~(ok & ~skip)
        lo = torch.where(feas, mid, lo)
        best_eta = torch.where(feas, mid, best_eta)
        best_p = torch.where(feas[..., None], p_star, best_p)
        hi = torch.where(infeas, mid, hi)
    # a cell that still had gap > eps when the loop stopped hit max_iters
    info = {"eta": best_eta, "bisection_iters": iters.to(bits.dtype),
            "bisection_gap": hi - lo,
            "bisection_converged": (hi - lo) <= eps}
    return _finish(cb, bits, mask, best_p, info)


# ----------------------------------------------------------- dinkelbach
def dinkelbach_solve(cb: ChannelBatch, bits, mask=None,
                     p_circuit_w: float = 0.2, outer: int = 12,
                     inner: int = 60, lr: float = 0.1, tol: float = 1e-6,
                     grad_mode: Optional[str] = None
                     ) -> BatchedPowerSolution:
    """Batched Dinkelbach energy-efficiency maximizer: the reference's
    outer update and early exit replayed with a per-cell done mask.
    ``info["ee_trace"]`` [B, outer] holds the running-best lambda after
    each outer iteration (frozen after convergence)."""
    bits, mask = _inputs(cb, bits, mask)
    grad = _grad_fn(_resolve_grad_mode(grad_mode, cb.A_bar.dtype))
    numer = _sum_rate_obj(_normalize(cb), mask)

    def denom(p):
        m = _lift(mask, _extra_axes(p, mask), 1)
        return p_circuit_w + cb.p_max_w * torch.sum(p * m, dim=-1)

    p = mask * 1.0
    lam = numer(p) / denom(p)
    p_best, lam_best = p, lam
    done = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    used = torch.zeros_like(lam)
    f_last = torch.full_like(lam, float("inf"))
    safeguard = torch.zeros_like(lam)
    trace = []
    for _ in range(outer):
        # inner: max_p numer(p) - lam * denom(p) by projected ascent
        def obj(q, lam=lam):
            return numer(q) - _lift(lam, _extra_axes(q, mask), 0) * denom(q)

        p_new = p
        for _ in range(inner):
            p_new = torch.clamp(p_new + lr * grad(obj, p_new, mask), 0.0, 1.0)
        p = torch.where(done[..., None], p, p_new)
        f = numer(p) - lam * denom(p)
        lam_new = numer(p) / denom(p)
        used = used + torch.where(done, 0.0, 1.0)
        lam = torch.where(done, lam, lam_new)
        # safeguard: the projected-ascent inner solve is inexact, so the
        # raw lambda sequence need not be monotone; the running best
        # keeps Dinkelbach's monotone-EE contract without touching the
        # reference trajectory
        improved = ~done & (lam_new > lam_best)
        p_best = torch.where(improved[..., None], p, p_best)
        lam_best = torch.where(improved, lam_new, lam_best)
        # diagnostics: the last residual |f| before convergence, and how
        # often the safeguard rejected a non-improving step
        f_last = torch.where(done, f_last, torch.abs(f))
        safeguard = safeguard + torch.where(~done & ~improved, 1.0, 0.0)
        done = done | (~done & (torch.abs(f) < tol))
        trace.append(lam_best)
    info = {"energy_efficiency": lam_best, "dinkelbach_iters": used,
            "dinkelbach_converged": done, "dinkelbach_residual": f_last,
            "dinkelbach_safeguard": safeguard,
            "ee_trace": torch.stack(trace, dim=-1)}   # [B, outer]
    return _finish(cb, bits, mask, p_best, info)


# -------------------------------------------------------- max-sum-rate
def maxsum_starts(mask_np: np.ndarray, restarts: int) -> np.ndarray:
    """Reference start points per cell: full power + ``restarts`` draws
    of default_rng(0).uniform(0.3, 1, K_active) scattered onto the
    active coordinates — MaxSumRatePowerControl.solve's on the
    corresponding sub-channel."""
    mask_np = np.asarray(mask_np, np.float64)
    B, K = mask_np.shape
    out = np.zeros((B, restarts + 1, K))
    for i in range(B):
        idx = np.flatnonzero(mask_np[i])
        rng = np.random.default_rng(0)
        out[i, 0, idx] = 1.0
        for r in range(restarts):
            out[i, 1 + r, idx] = rng.uniform(0.3, 1.0, len(idx))
    return out


def maxsum_solve(cb: ChannelBatch, bits, mask=None, iters: int = 80,
                 lr: float = 0.1, restarts: int = 2,
                 starts: Optional[np.ndarray] = None,
                 grad_mode: Optional[str] = None) -> BatchedPowerSolution:
    """Batched max-sum-rate projected gradient ascent with restarts; the
    first restart of maximal sum rate wins."""
    bits, mask = _inputs(cb, bits, mask)
    grad = _grad_fn(_resolve_grad_mode(grad_mode, cb.A_bar.dtype))
    if starts is None:
        starts = maxsum_starts(mask.cpu().numpy(), restarts)
    p = torch.as_tensor(starts, dtype=mask.dtype, device=mask.device)
    cbn = _normalize(cb)
    obj = _sum_rate_obj(cbn, mask)
    mask_e = mask[..., None, :]
    for _ in range(iters):
        p = torch.clamp(p + lr * grad(obj, p, mask_e), 0.0, 1.0)
    v = obj(p)                                       # [B, R]
    best = torch.argmax(v, dim=-1)                   # first max wins
    p_best = torch.take_along_dim(p, best[..., None, None], dim=-2)[..., 0, :]
    # first-order stationarity of the winning restart (diagnostic only)
    g_best = grad(obj, p_best, mask)
    info = {"sum_rate": torch.amax(v, dim=-1),
            "maxsum_grad_norm": torch.linalg.vector_norm(g_best, dim=-1),
            "maxsum_iters": torch.full(v.shape[:-1], float(iters),
                                       dtype=p.dtype, device=p.device)}
    return _finish(cb, bits, mask, p_best, info)


# ------------------------------------------------------------- registry
def batched_solver(controller) -> Callable:
    """Map one of the port's ``PowerController`` instances to its batched
    counterpart with the instance's hyper-parameters.  Returns
    ``solve(cb, bits, mask=None) -> BatchedPowerSolution``."""
    name = controller.name
    if name == "bisection-lp":
        return partial(bisection_solve, eps_rel=controller.eps_rel,
                       max_iters=controller.max_iters)
    if name == "dinkelbach":
        return partial(dinkelbach_solve,
                       p_circuit_w=controller.p_circuit_w,
                       outer=controller.outer, inner=controller.inner,
                       lr=controller.lr, tol=controller.tol)
    if name == "max-sum-rate":
        return partial(maxsum_solve, iters=controller.iters,
                       lr=controller.lr, restarts=controller.restarts)
    raise KeyError(f"no batched solver for power controller {name!r}")


__all__ = ["BatchedPowerSolution", "batched_solver", "bisection_solve",
           "dinkelbach_solve", "eta_upper_bound_batch", "maxsum_solve",
           "maxsum_starts"]

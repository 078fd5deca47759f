"""The port's batched physical layer (``repro_torch.phy``) against the
JAX package's.

Two precisions, each against its own reference (DESIGN.md section 7):

* float64 with ``grad_mode="fd"`` (the parity mode) against the JAX
  package's numpy references (``repro.core.channel``,
  ``repro.core.power``) on 100 realizations of ``CFmMIMOConfig(K=10,
  M=9)``: bundle 1e-12, rate evaluation 1e-10, bisection and
  Dinkelbach 1e-5, max-sum at 5 iterations 1e-5, and at full settings
  the objective within 5e-2 of the reference's;
* float32 with ``grad_mode="auto"`` against ``repro.phy`` in JAX's
  default f32 on the same inputs: bundle 1e-5, rates 1e-2, bisection
  1e-3, Dinkelbach 1e-2.

JAX runs in its default f32 throughout; ``jax_enable_x64`` is never
flipped (other files share the worker).  Beside the parity checks: the
mask against the port's host sub-channel solve, an exactly singular
system that is infeasible without raising, the solution invariants
(p in [0, 1], masked users 0, a monotone ``ee_trace``, bisection's
straggler no worse than max-sum's) and the first-max rule on a tie.
"""
import numpy as np
import pytest
import torch

from repro import phy as jphy
from repro.core.channel import CFmMIMOConfig as JChanCfg
from repro.core.channel import make_channel as jmake_channel
from repro.core.power import (BisectionLPPowerControl as JBisection,
                              DinkelbachPowerControl as JDinkelbach,
                              MaxSumRatePowerControl as JMaxSum,
                              equalizing_target_latency, eta_upper_bound,
                              rate_aware_fractions)
from repro_torch import phy
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.core.power import (BisectionLPPowerControl,
                                    DinkelbachPowerControl,
                                    MaxSumRatePowerControl)
from repro_torch.phy.solvers import _feasible_point
from repro_torch.sim.engine import _subchannel

N_REAL = 100
CFG = dict(K=10, M=9)
F64, F32 = torch.float64, torch.float32
# DESIGN.md section 7: (float64 vs numpy, float32 vs JAX f32)
TOL_BUNDLE = {F64: 1e-12, F32: 1e-5}
TOL_RATES_EVAL = {F64: 1e-10, F32: 1e-2}
TOL_BISECTION = {F64: 1e-5, F32: 1e-3}
TOL_DINKELBACH = {F64: 1e-5, F32: 1e-2}
TOL_MAXSUM_SHORT = 1e-5
TOL_OBJ_QUALITY = 5e-2
# bisection certifies eta within eps_rel of the optimum, so its
# straggler may exceed an accidentally optimal competitor's by as much
BISECTION_SLACK = 1e-3


@pytest.fixture(scope="module")
def realizations():
    return [jmake_channel(JChanCfg(**CFG), seed=s) for s in range(N_REAL)]


@pytest.fixture(scope="module")
def payloads():
    return np.random.default_rng(1).uniform(1e5, 2e6, (N_REAL, CFG["K"]))


@pytest.fixture(scope="module")
def bundles(realizations):
    return {dt: phy.bundle_from_realizations(realizations, dtype=dt,
                                             device="cpu")
            for dt in (F64, F32)}


@pytest.fixture(scope="module")
def jbundle(realizations):
    return jphy.bundle_from_realizations(realizations)


@pytest.fixture(scope="module")
def references(realizations, payloads):
    """The numpy reference solves, once per realization."""
    return {
        "bisection": [JBisection().solve(c, payloads[i])
                      for i, c in enumerate(realizations)],
        "dinkelbach": [JDinkelbach().solve(c, payloads[i])
                       for i, c in enumerate(realizations)],
        "maxsum": [JMaxSum().solve(c, payloads[i])
                   for i, c in enumerate(realizations)],
    }


def rel(a, b, floor=1.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


def np64(x):
    return x.double().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float64)


# ------------------------------------------------------------- channel
@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_bundle_matches_reference(realizations, dtype):
    """make_channel_batch (host geometry, eq. 5 in torch) against the
    numpy bundles (float64) and against JAX's f32 make_channel_batch."""
    cb = phy.make_channel_batch(CFmMIMOConfig(**CFG), list(range(N_REAL)),
                                dtype=dtype, device="cpu")
    assert cb.A_bar.dtype == dtype and cb.batch_shape == (N_REAL,)
    want = None if dtype == F64 else jphy.make_channel_batch(
        JChanCfg(**CFG), list(range(N_REAL)))
    for f in ("A_bar", "B_bar", "B_tilde", "I_M"):
        ref = np.stack([getattr(c, f) for c in realizations]) \
            if want is None else np64(np.asarray(getattr(want, f)))
        got = np64(getattr(cb, f))
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
        assert err.max() < TOL_BUNDLE[dtype], (f, err.max())


@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_rates_and_eta_bound_match_reference(realizations, bundles,
                                             jbundle, payloads, dtype):
    cb = bundles[dtype]
    p = np.random.default_rng(2).uniform(0.05, 1.0, (N_REAL, CFG["K"]))
    pt = torch.as_tensor(p, dtype=dtype)
    if dtype == F64:
        want_rates = np.stack([c.rates(p[i])
                               for i, c in enumerate(realizations)])
        want_eta = [eta_upper_bound(c, payloads[i])
                    for i, c in enumerate(realizations)]
    else:
        want_rates = np64(np.asarray(jbundle.rates(p)))
        want_eta = np64(np.asarray(jphy.eta_upper_bound_batch(jbundle,
                                                              payloads)))
    assert rel(np64(cb.rates(pt)), want_rates, 0.0) < TOL_RATES_EVAL[dtype]
    assert rel(np64(phy.eta_upper_bound_batch(cb, payloads)), want_eta,
               0.0) < TOL_RATES_EVAL[dtype]


def test_uplink_latency_masks_absent_users():
    bits = torch.tensor([[4.0, 8.0, 2.0]], dtype=F64)
    rates = torch.tensor([[2.0, 0.0, 1.0]], dtype=F64)
    lat = phy.uplink_latency_batch(bits, rates, torch.tensor([[1, 0, 1.]],
                                                             dtype=F64))
    assert lat.tolist() == [[2.0, 0.0, 2.0]]
    assert float(phy.uplink_latency_batch(bits, rates)[0, 1]) == 8.0 / 1e-9


# ----------------------------------------------------------- bisection
@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_bisection_matches_reference(bundles, jbundle, references,
                                     payloads, dtype):
    """float64: the scipy-LP reference's rates, eta and straggler within
    1e-5 (same decisions, same min-sum-power vector); float32: JAX's f32
    batched solve within 1e-3."""
    sol = phy.bisection_solve(bundles[dtype], payloads)
    if dtype == F64:
        ref = references["bisection"]
        want = (np.stack([r.rates for r in ref]),
                [r.info["eta"] for r in ref],
                [r.straggler_latency for r in ref])
    else:
        j = jphy.bisection_solve(jbundle, payloads)
        want = (np.asarray(j.rates), np.asarray(j.info["eta"]),
                np.asarray(j.straggler_latency))
    tol = TOL_BISECTION[dtype]
    assert rel(np64(sol.rates), want[0], 0.0) < tol
    assert rel(np64(sol.info["eta"]), want[1], 1e-12) < tol
    assert rel(np64(sol.straggler_latency), want[2], 1e-12) < tol
    assert bool(sol.info["bisection_converged"].all())
    p = np64(sol.p)
    assert np.all((p >= 0.0) & (p <= 1.0))


def test_masked_bisection_matches_host_subchannel(bundles, payloads):
    """The mask is the engine's sub-channel: absent users get no power
    and no latency, and the straggler equals the port's host solve on
    the active users' sub-channel."""
    n, K = 30, CFG["K"]
    rng = np.random.default_rng(3)
    mask = (rng.random((n, K)) < 0.6).astype(np.float64)
    mask[mask.sum(axis=1) == 0, 0] = 1.0
    bits = np.where(mask > 0, payloads[:n], 1.0)
    chans = [make_channel(CFmMIMOConfig(**CFG), seed=s) for s in range(n)]
    sol = phy.bisection_solve(
        phy.bundle_from_realizations(chans, dtype=F64, device="cpu"), bits,
        mask=mask)
    assert np.all(np64(sol.p)[mask == 0] == 0.0)
    assert np.all(np64(sol.latencies)[mask == 0] == 0.0)
    got = np64(sol.straggler_latency)
    for i in range(n):
        idx = np.flatnonzero(mask[i])
        ref = BisectionLPPowerControl().solve(_subchannel(chans[i], idx),
                                              bits[i][idx])
        assert abs(got[i] - ref.straggler_latency) \
            / ref.straggler_latency < TOL_BISECTION[F64]


@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_singular_system_is_infeasible_not_an_error(dtype):
    """Row 0's ``I - M`` is exactly singular ([[1, -1], [-1, 1]]): the
    solve neither raises nor poisons row 1, and row 0 is infeasible.
    The whole bisection on that bundle runs through as well."""
    cb = phy.ChannelBatch(
        A_bar=torch.tensor([[2.0, 2.0], [2.0, 2.0]], dtype=dtype),
        B_bar=torch.zeros(2, 2, dtype=dtype),
        B_tilde=torch.tensor([[[0.0, 2.0], [2.0, 0.0]],
                              [[0.0, 0.5], [0.5, 0.0]]], dtype=dtype),
        I_M=torch.tensor([[0.1, 0.1], [0.1, 0.1]], dtype=dtype),
        pre_log=1.0, p_max_w=0.1)
    mask = torch.ones(2, 2, dtype=dtype)
    theta = torch.ones(2, 2, dtype=dtype)
    eye = torch.eye(2, dtype=dtype)
    p_star, ok = _feasible_point(cb, mask, theta, eye)
    assert ok.tolist() == [False, True]
    # row 1: (I - M) p = c with M = 0.25 off the diagonal, c = 0.05
    assert torch.allclose(p_star[1], torch.full((2,), 0.05 / 0.75,
                                                dtype=dtype))
    sol = phy.bisection_solve(cb, np.full((2, 2), 1.0))
    p = np64(sol.p)
    assert np.all(np.isfinite(p)) and np.all((p >= 0.0) & (p <= 1.0))


# ---------------------------------------------------------- dinkelbach
def test_dinkelbach_fd_matches_numpy(bundles, references, payloads):
    """fd mode replays the reference's trajectory (which never leaves
    the all-ones clip: the FD gradient is exactly 0 there)."""
    sol = phy.dinkelbach_solve(bundles[F64], payloads, grad_mode="fd")
    want = np.stack([r.rates for r in references["dinkelbach"]])
    assert rel(np64(sol.rates), want, 0.0) < TOL_DINKELBACH[F64]


def test_dinkelbach_f32_against_jax_and_reference(bundles, jbundle,
                                                  references, payloads):
    """float32.  With ``grad_mode="fd"`` the all-ones start is a fixed
    point (the forward difference at the clip is structurally 0), so the
    rates match JAX's f32 fd solve within 1e-2.  With ``"auto"`` (the
    f32 default) the ascent is chaotic: f32 roundoff sends a cell to
    another local optimum (the port's own f32 and float64 runs end more
    than 1e-2 apart on most cells, and so do the port's and JAX's f32
    runs), so, as the JAX package's contract states, the energy
    efficiency is held to be no worse than the reference's by more than
    5e-2, and the trace to be monotone."""
    fd = phy.dinkelbach_solve(bundles[F32], payloads, grad_mode="fd")
    j = jphy.dinkelbach_solve(jbundle, payloads, grad_mode="fd")
    assert rel(np64(fd.rates), np.asarray(j.rates), 0.0) \
        < TOL_DINKELBACH[F32]
    sol = phy.dinkelbach_solve(bundles[F32], payloads)
    got = np64(sol.info["energy_efficiency"])
    ref = np.array([r.info["energy_efficiency"]
                    for r in references["dinkelbach"]])
    assert np.all(got >= ref * (1.0 - TOL_OBJ_QUALITY))
    assert np.all(np.diff(np64(sol.info["ee_trace"]), axis=-1) >= 0.0)


# ------------------------------------------------------- max-sum-rate
def test_maxsum_short_trajectory_matches_numpy(realizations, bundles,
                                               payloads):
    """Before FD noise bifurcates the non-convex ascent, the batched
    trajectory tracks numpy's (float64, fd)."""
    sol = phy.maxsum_solve(bundles[F64], payloads, iters=5, restarts=2,
                           grad_mode="fd")
    want = np.stack([JMaxSum(iters=5, restarts=2).solve(c, payloads[i]).rates
                     for i, c in enumerate(realizations)])
    # absolute floor 1 bit/s: the ascent may switch a user fully off
    assert rel(np64(sol.rates), want) < TOL_MAXSUM_SHORT


@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_maxsum_full_quality(bundles, references, payloads, dtype):
    """Full settings bifurcate (float64 fd and float32 autodiff alike);
    the sum rate stays within 5e-2 of the reference's local optimum."""
    sol = phy.maxsum_solve(bundles[dtype], payloads)
    got = np64(sol.info["sum_rate"])
    ref = np.array([r.info["sum_rate"] for r in references["maxsum"]])
    assert np.all(got >= ref * (1.0 - TOL_OBJ_QUALITY))


def test_maxsum_first_maximal_restart_wins():
    """Two users of identical coefficients and two starts that swap
    them: the objectives tie exactly and the first start wins, as
    ``jnp.argmax`` picks it."""
    cb = phy.ChannelBatch(
        A_bar=torch.tensor([[3.0, 3.0]], dtype=F64),
        B_bar=torch.tensor([[0.2, 0.2]], dtype=F64),
        B_tilde=torch.tensor([[[0.0, 0.7], [0.7, 0.0]]], dtype=F64),
        I_M=torch.tensor([[0.1, 0.1]], dtype=F64), pre_log=1.0,
        p_max_w=0.1)
    starts = np.array([[[1.0, 0.5], [0.5, 1.0]]])
    sol = phy.maxsum_solve(cb, np.ones((1, 2)), iters=0, starts=starts)
    assert np64(sol.p).tolist() == [[1.0, 0.5]]
    jcb = jphy.ChannelBatch(*(np.asarray(getattr(cb, f)) for f in
                              ("A_bar", "B_bar", "B_tilde", "I_M")),
                            pre_log=1.0, p_max_w=0.1)
    j = jphy.maxsum_solve(jcb, np.ones((1, 2)), iters=0, starts=starts)
    assert np.asarray(j.p).tolist() == [[1.0, 0.5]]


def test_maxsum_starts_equal_jax():
    mask = (np.random.default_rng(5).random((7, 9)) < 0.6).astype(float)
    np.testing.assert_array_equal(phy.maxsum_starts(mask, 3),
                                  jphy.maxsum_starts(mask, 3))


# ---------------------------------------------------------- invariants
def problem(seed, spread, participation, k=8, m=4):
    chans = [make_channel(CFmMIMOConfig(K=k, M=m), seed=seed + i)
             for i in range(4)]
    rng = np.random.default_rng(seed)
    bits = rng.uniform(1e5, 1e5 * spread, (4, k))
    mask = (rng.random((4, k)) < participation).astype(np.float64)
    mask[mask.sum(axis=1) == 0, 0] = 1.0
    bits = np.where(mask > 0, np.maximum(bits, 1.0), 1.0)
    return phy.bundle_from_realizations(chans, device="cpu"), bits, mask


@pytest.mark.parametrize("seed,spread,participation",
                         [(0, 20.0, 1.0), (7, 10.0, 0.6), (3, 1.0, 1.0)],
                         ids=["full", "churn", "equal-payloads"])
def test_solution_invariants(seed, spread, participation):
    """float32 (the driver's precision): p in [0, 1] and 0 for masked
    users, finite latencies, a monotone positive ``ee_trace``, and
    bisection's straggler no worse than max-sum's."""
    cb, bits, mask = problem(seed, spread, participation)
    ours = phy.bisection_solve(cb, bits, mask=mask)
    dink = phy.dinkelbach_solve(cb, bits, mask=mask)
    msum = phy.maxsum_solve(cb, bits, mask=mask)
    for sol in (ours, dink, msum):
        p = np64(sol.p)
        assert np.all(p >= 0.0) and np.all(p <= 1.0)
        assert np.all(p[mask == 0] == 0.0)
        assert np.all(np.isfinite(np64(sol.latencies)))
    trace = np64(dink.info["ee_trace"])
    assert trace.shape == (4, DinkelbachPowerControl().outer)
    assert np.all(np.diff(trace, axis=-1) >= 0.0) and np.all(trace > 0.0)
    assert np.all(np64(ours.straggler_latency)
                  <= np64(msum.straggler_latency) * (1.0 + BISECTION_SLACK))


# ------------------------------------------------------------ bitalloc
@pytest.mark.parametrize("dtype", [F64, F32], ids=["float64", "float32"])
def test_bitalloc_matches_numpy(dtype):
    rates = np.random.default_rng(4).uniform(1e5, 1e7, (16, 12))
    d, b = 100_000, 10
    ref_ell = np.array([equalizing_target_latency(r, d, b, 0.01)
                        for r in rates])
    rt = torch.as_tensor(rates, dtype=dtype)
    got_ell = phy.equalizing_target_latency_batch(rt, d, b, 0.01)
    np.testing.assert_allclose(np64(got_ell), ref_ell,
                               rtol=1e-12 if dtype == F64 else 1e-5)
    ref_s = np.stack([rate_aware_fractions(r, d, b, ref_ell[i], s_min=0.01)
                      for i, r in enumerate(rates)])
    got_s = phy.rate_aware_fractions_batch(rt, d, b, got_ell[:, None],
                                           s_min=0.01)
    np.testing.assert_allclose(np64(got_s), ref_s,
                               atol=1e-10 if dtype == F64 else 1e-4)


def test_batched_solver_takes_the_controllers_settings():
    solve = phy.batched_solver(BisectionLPPowerControl(eps_rel=1e-3,
                                                       max_iters=7))
    assert solve.func is phy.bisection_solve
    assert solve.keywords == {"eps_rel": 1e-3, "max_iters": 7}
    solve = phy.batched_solver(DinkelbachPowerControl(outer=4, inner=15))
    assert solve.keywords == {"p_circuit_w": 0.2, "outer": 4, "inner": 15,
                              "lr": 0.1, "tol": 1e-6}
    solve = phy.batched_solver(MaxSumRatePowerControl(iters=20, restarts=0))
    assert solve.keywords == {"iters": 20, "lr": 0.1, "restarts": 0}

    class Other:
        name = "water-filling"
    with pytest.raises(KeyError, match="water-filling"):
        phy.batched_solver(Other())
    with pytest.raises(ValueError, match="grad_mode"):
        phy.maxsum_solve(problem(0, 2.0, 1.0)[0], np.ones((4, 8)),
                         grad_mode="exact")

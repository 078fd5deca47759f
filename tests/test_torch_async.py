"""Async rounds in the port (DESIGN.md §11) against the JAX package, on
the CPU.

* The host event clock: ``staleness_weights`` and
  ``advance_async_clock`` give exactly JAX's outputs on the same inputs
  (hypothesis and a seeded battery), with JAX's properties: convex
  weights, drops, the quantile deadline, an idle round.
* The engine: ``async_mode`` without a deadline is the lockstep run bit
  for bit in both drivers; a huge finite deadline reduces to it in
  bits and latency; uploads are conserved under churn on the dense and
  packed planes; busy users start no fresh upload; ``finish_round``
  charges the event clock; a round makes two step calls and one solve
  for any K and R; on the packed plane the aggregate is one K3 over 2K
  slots; the staleness sweep axes run with replicates.
* Against JAX's engine fed the same solve latencies: ``round_s``, the
  arrivals and the weights exactly, params by
  ``assert_trajectory_close``.

A narrow paper CNN (12x12 inputs, 8 filters, 16 dense units), K = 4 to
6 users, L = 1 or 2 local steps of batch 8, M = 4 APs of N = 2
antennas.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_parity import assert_trajectory_close, run_mismatches

from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.core.channel import CFmMIMOConfig as JChanCfg
from repro.core.channel import make_channel as jmake_channel
from repro.core.power import BisectionLPPowerControl as JBisection
from repro.core.quantize import MixedResolutionQuantizer as JMixed
from repro.data import make_image_classification as jmake_data
from repro.data import partition_dirichlet as jdirichlet
from repro.fl.loop import FLConfig as JFL
from repro.kernels import WirePath as JWire
from repro.sim import EngineConfig as JEngineConfig
from repro.sim import StalenessConfig as JStaleness
from repro.sim import VectorizedFLEngine as JEngine
from repro.sim import advance_async_clock as jadvance
from repro.sim import async_scenarios as jasync_scenarios
from repro.sim import get_scenario as jget_scenario
from repro.sim import staleness_weights as jweights
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.core.power import BisectionLPPowerControl
from repro_torch.core.quantize import MixedResolutionQuantizer
from repro_torch.data import make_image_classification, partition_dirichlet
from repro_torch.fl.cnn import params_from_jax
from repro_torch.fl.loop import FLConfig
from repro_torch.kernels import WirePath, ops
from repro_torch.sim import (EngineConfig, StalenessConfig,
                             VectorizedFLEngine, advance_async_clock,
                             async_scenarios, get_scenario, make_engine,
                             run_cell, run_grid, run_grid_batched,
                             staleness_weights)
from repro_torch.sim import scenarios as tscenarios

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
Q = ("mixed-resolution", {"lambda_": 0.2, "b": 4})
POWER = {"bisection-lp": "bisection-lp"}
STEP_FIELDS = ("round_s", "arrived", "w_fresh", "w_buf", "move", "keep",
               "in_flight", "remaining_s", "staleness", "arrived_staleness",
               "dropped_stale", "dropped_churn", "straggler_gap_s")


@pytest.fixture(scope="module")
def narrow():
    """A narrow CNN under the dataset name ``narrow-syn`` (d = 3610)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tscenarios._DATASETS, "narrow-syn",
                   (PaperCNNConfig(name="narrow", **NARROW), 10))
        yield


def tiny(name, **kw):
    fields = dict(K=4, T=4, n_train=240, n_test=60, batch_size=8, L=1,
                  M=4, N=2, dataset="narrow-syn", eval_every=1,
                  name=f"{name}-tiny")
    fields.update(kw)
    return dataclasses.replace(get_scenario(name), **fields)


def step_of(eng, state, t):
    """One async round through the round-stepping API."""
    work = eng.train_round(state, t)
    up, pu = eng.solve_uplink_host(state.chan, work.bits_np, work.active)
    info = eng.complete_round_async(state, work, pu)
    eng.finish_round(state, work, up, async_info=info, per_user_s=pu)
    return work, up, pu, info


# ------------------------------------------------------ event clock
def random_clock_inputs(rng, B, K):
    in_flight = rng.uniform(size=(B, K)) < 0.4
    return dict(
        in_flight=in_flight,
        remaining_s=np.where(in_flight, rng.uniform(0.0, 3.0, (B, K)), 0.0),
        staleness=np.where(in_flight, rng.integers(1, 4, (B, K)), 0),
        ell=rng.uniform(0.1, 5.0, (B, K)),
        fresh=(rng.uniform(size=(B, K)) < 0.7) & ~in_flight,
        participating=rng.uniform(size=(B, K)) < 0.8,
        rho=rng.uniform(0.05, 2.0, K))


def configs(rng):
    alpha = float(rng.uniform(0.0, 3.0))
    depth = int(rng.integers(0, 4))
    return [(dict(deadline_s=float(rng.uniform(0.2, 4.0)), alpha=alpha,
                  max_staleness=depth)),
            dict(deadline_quantile=float(rng.uniform(0.05, 1.0)),
                 alpha=alpha, max_staleness=depth)]


def assert_clock_equal(seed, B, K):
    rng = np.random.default_rng(seed)
    inputs = random_clock_inputs(rng, B, K)
    for cfg in configs(rng):
        got = advance_async_clock(**inputs, cfg=StalenessConfig(**cfg))
        want = jadvance(**inputs, cfg=JStaleness(**cfg))
        for f in STEP_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 4), st.integers(1, 12))
def test_clock_equals_jax_hypothesis(seed, B, K):
    """Every field of the transition exactly JAX's, on random buffers,
    latencies, masks, fixed and quantile deadlines, alpha and depths."""
    assert_clock_equal(seed, B, K)


@pytest.mark.parametrize("seed", range(6))
def test_clock_equals_jax_seeded(seed):
    """The same on a fixed battery (runs without hypothesis too)."""
    assert_clock_equal(1000 + seed, 1 + seed % 3, 3 + 2 * seed)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 16),
       st.floats(0.0, 8.0, allow_nan=False))
def test_staleness_weights_equal_jax_and_are_convex(seed, K, alpha):
    """JAX's weights bit for bit, non-negative, zero off the arrived set
    and summing to 1 on every row where something arrived (0 where
    nothing did)."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.05, 3.0, size=K)
    stale = rng.integers(0, 5, size=(3, K))
    arrived = rng.uniform(size=(3, K)) < 0.5
    w = staleness_weights(rho, stale, arrived, alpha)
    assert np.array_equal(w, jweights(rho, stale, arrived, alpha))
    assert np.all(w >= 0.0) and np.all(w[~arrived] == 0.0)
    tot = w.sum(axis=-1)
    np.testing.assert_allclose(tot[arrived.any(-1)], 1.0, rtol=1e-12)
    assert np.all(tot[~arrived.any(-1)] == 0.0)


def test_clock_cases_of_the_reference_battery():
    """JAX's unit cases: a deadline between two uploads buffers the slow
    one; a buffered upload arrives at weight (1+s)^-alpha; churn drops
    an in-flight upload; the staleness bound drops, and depth 0 drops
    every miss; the quantile deadline and an idle round."""
    cfg = StalenessConfig
    Z = np.zeros((1, 2))
    s = advance_async_clock(Z.astype(bool), Z.copy(), Z.astype(int),
                            np.array([[1.0, 4.0]]), np.ones((1, 2), bool),
                            np.ones((1, 2), bool), np.ones(2),
                            cfg(deadline_s=2.0, max_staleness=2))
    assert s.round_s[0] == 2.0 and s.in_flight.tolist() == [[False, True]]
    np.testing.assert_allclose(s.remaining_s, [[0.0, 2.0]])
    s = advance_async_clock(np.array([[True, False]]),
                            np.array([[0.5, 0.0]]), np.array([[1, 0]]),
                            np.array([[0.0, 1.0]]),
                            np.array([[False, True]]), np.ones((1, 2), bool),
                            np.ones(2), cfg(deadline_s=2.0, alpha=1.0))
    np.testing.assert_allclose([s.w_buf[0, 0], s.w_fresh[0, 1]],
                               [0.5 / 1.5, 1.0 / 1.5])
    s = advance_async_clock(np.array([[True, False]]),
                            np.array([[0.1, 0.0]]), np.array([[1, 0]]),
                            np.array([[0.0, 1.0]]),
                            np.array([[False, True]]),
                            np.array([[False, True]]), np.ones(2),
                            cfg(deadline_s=5.0, max_staleness=3))
    assert s.dropped_churn[0] == 1 and not s.arrived[0, 0]
    s = advance_async_clock(np.array([[True]]), np.array([[9.0]]),
                            np.array([[2]]), np.array([[0.0]]),
                            np.array([[False]]), np.array([[True]]),
                            np.ones(1), cfg(deadline_s=1.0, max_staleness=2))
    assert s.dropped_stale[0] == 1 and not s.in_flight.any()
    s = advance_async_clock(Z.astype(bool), Z.copy(), Z.astype(int),
                            np.array([[1.0, 9.0]]), np.ones((1, 2), bool),
                            np.ones((1, 2), bool), np.ones(2),
                            cfg(deadline_s=2.0, max_staleness=0))
    assert s.dropped_stale[0] == 1 and not s.in_flight.any()
    s = advance_async_clock(np.zeros((1, 4), bool), np.zeros((1, 4)),
                            np.zeros((1, 4), int),
                            np.array([[1.0, 2.0, 3.0, 4.0]]),
                            np.ones((1, 4), bool), np.ones((1, 4), bool),
                            np.ones(4), cfg(deadline_quantile=0.5))
    np.testing.assert_allclose([s.round_s[0], s.straggler_gap_s[0]],
                               [2.5, 1.5])
    s = advance_async_clock(np.zeros((1, 2), bool), np.zeros((1, 2)),
                            np.zeros((1, 2), int), np.zeros((1, 2)),
                            np.zeros((1, 2), bool), np.ones((1, 2), bool),
                            np.ones(2), cfg(deadline_quantile=0.5))
    assert s.round_s[0] == 0.0 and s.w_fresh.sum() == s.w_buf.sum() == 0.0


@pytest.mark.parametrize("kw", [
    dict(deadline_s=1.0, deadline_quantile=0.5), dict(deadline_s=-1.0),
    dict(deadline_quantile=1.5), dict(alpha=-0.1), dict(max_staleness=-1)])
def test_staleness_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JStaleness(**kw)
    with pytest.raises(ValueError):
        StalenessConfig(**kw)


def test_sync_configs_and_async_active_match_jax():
    for kw in (dict(), dict(deadline_s=float("inf")), dict(deadline_s=1.0),
               dict(deadline_quantile=0.5)):
        assert StalenessConfig(**kw).is_sync == JStaleness(**kw).is_sync
        for mode in (False, True):
            assert EngineConfig(async_mode=mode,
                                staleness=StalenessConfig(**kw)).async_active \
                == JEngineConfig(async_mode=mode,
                                 staleness=JStaleness(**kw)).async_active


# ------------------------------------------------- sync reduction
def assert_same_runs(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        results = ra.result if isinstance(ra.result, list) else [ra.result]
        others = rb.result if isinstance(rb.result, list) else [rb.result]
        for x, y in zip(results, others, strict=True):
            assert run_mismatches(x, y) == []


@pytest.mark.parametrize("driver", ["run_grid", "run_grid_batched",
                                    "replicated"])
def test_sync_reduction_bit_for_bit(narrow, driver):
    """``async_mode=True`` with no deadline runs the lockstep path
    itself: logs and params bit for bit, under churn, in the host
    driver, the batched driver and its replicate axis."""
    base = tiny("churn-0.7", participation=0.5)
    reduced = dataclasses.replace(base, name="sync-red-tiny",
                                  async_mode=True)
    assert not reduced.async_active
    q = {"mixed": Q, "classic": ("classic", {})}
    run = {"run_grid": lambda s: run_grid([s], q, POWER, quick=False,
                                          device="cpu"),
           "run_grid_batched": lambda s: run_grid_batched(
               [s], q, POWER, quick=False, device="cpu"),
           "replicated": lambda s: run_grid_batched(
               [s], {"mixed": Q}, POWER, quick=False, device="cpu",
               replicates=2)}[driver]
    assert_same_runs(run(base), run(reduced))


def test_huge_finite_deadline_reduces_to_lockstep(narrow):
    """A finite deadline no upload misses: the event clock runs, every
    upload arrives fresh, the bits are the lockstep run's, latencies
    within 1e-6 and params to roundoff (the aggregate is another sum)."""
    base = tiny("churn-0.7", participation=0.5, aggregation="dense")
    huge = dataclasses.replace(base, name="huge-tiny", async_mode=True,
                               deadline_s=1e9)
    assert huge.async_active
    a = run_cell(base, Q, "bisection-lp", quick=False, device="cpu")
    b = run_cell(huge, Q, "bisection-lp", quick=False, device="cpu")
    for la, lb in zip(a.result.logs, b.result.logs, strict=True):
        np.testing.assert_array_equal(la.bits_per_user, lb.bits_per_user)
        np.testing.assert_allclose(lb.uplink_latency_s, la.uplink_latency_s,
                                   rtol=1e-6)
        assert lb.mean_staleness == 0.0 and lb.dropped_uploads == 0
    for k in a.result.params:
        np.testing.assert_allclose(b.result.params[k].numpy(),
                                   a.result.params[k].numpy(), atol=1e-6)


# -------------------------------------------------- engine behaviour
@pytest.mark.parametrize("aggregation", ["dense", "wire"])
def test_upload_conservation_under_churn(narrow, aggregation):
    """Every upload started is aggregated, dropped (stale or churn) or
    still in flight; churn drops happen."""
    scn = tiny("async-churn", T=6, aggregation=aggregation,
               participation=0.6)
    eng = make_engine(scn, Q, "bisection-lp", device="cpu")
    state = eng.start_run()
    for t in range(1, scn.T + 1):
        step_of(eng, state, t)
    c = state.async_clock
    assert c.uploads_started > 0 and c.dropped_churn > 0
    assert c.uploads_started == (c.arrived_total + c.dropped_stale
                                 + c.dropped_churn + int(c.in_flight.sum()))


@pytest.mark.parametrize("aggregation", ["dense", "wire"])
def test_busy_users_start_no_fresh_upload(narrow, aggregation):
    scn = tiny("async-q50", T=5, aggregation=aggregation)
    eng = make_engine(scn, Q, "bisection-lp", device="cpu")
    state = eng.start_run()
    saw_busy = False
    for t in range(1, scn.T + 1):
        busy = state.async_clock.in_flight[0].copy()
        saw_busy |= bool(busy.any())
        work, _, _, _ = step_of(eng, state, t)
        assert not np.any((work.active > 0) & busy)
        assert np.all(work.bits_np[work.active == 0] == 0.0)
    assert saw_busy and state.async_clock.arrived_total > 0


def test_finish_round_charges_the_event_clock(narrow):
    """An async round costs the event clock's duration, under the
    lockstep straggler latency with a median deadline."""
    scn = tiny("async-q50", T=2)
    eng = make_engine(scn, Q, "bisection-lp", device="cpu")
    state = eng.start_run()
    work, up, pu, info = step_of(eng, state, 1)
    log = state.logs[-1]
    assert log.uplink_latency_s == float(info.round_uplink_s[0]) < up
    assert log.cum_latency_s == log.uplink_latency_s + eng.comp_lat
    assert log.effective_participation == \
        float(info.effective_participation[0])
    assert log.mean_staleness == float(info.mean_staleness[0])


@pytest.mark.parametrize("K,R", [(4, None), (6, None), (4, 1), (4, 3)])
def test_two_step_calls_and_one_solve_a_round(narrow, monkeypatch, K, R):
    """One train call and one aggregate call a round, and one batched
    solve, whatever K and the replicate count."""
    calls = {"train": 0, "agg": 0}
    orig = VectorizedFLEngine._async_steps

    def counting(self, n=None):
        train, agg = orig(self, n)

        def ctrain(*a, **k):
            calls["train"] += 1
            return train(*a, **k)

        def cagg(*a, **k):
            calls["agg"] += 1
            return agg(*a, **k)
        return ctrain, cagg

    monkeypatch.setattr(VectorizedFLEngine, "_async_steps", counting)
    from repro_torch.sim import phy_driver
    solves = []
    real = phy_driver.batched_solver
    monkeypatch.setattr(phy_driver, "batched_solver", lambda pc: (
        lambda *a, **k: (solves.append(1), real(pc)(*a, **k))[1]))
    T = 3
    run_grid_batched([tiny("async-q50", T=T, K=K)], {"mixed": Q}, POWER,
                     quick=False, device="cpu", replicates=R)
    assert calls == {"train": T, "agg": T} and len(solves) == T


def test_packed_aggregate_is_one_k3_over_2k_slots(narrow, monkeypatch):
    """On the packed plane an async round's aggregate is one K3 call over
    the fresh and buffered planes, 2K slots with 2K weights; the run
    tracks the dense plane's (the same quantizer, decoded in K3)."""
    seen = []
    real = ops._ref.mixed_res_dequant_reduce_ref

    def spy(signs, hi, codes, head, weights, b, acc=None):
        seen.append((signs.shape[0], weights.shape[0]))
        return real(signs, hi, codes, head, weights, b, acc=acc)

    scn = tiny("async-q50", T=4)
    wire = dataclasses.replace(scn, aggregation="wire")
    monkeypatch.setattr(ops._ref, "mixed_res_dequant_reduce_ref", spy)
    rw = run_cell(wire, Q, "bisection-lp", quick=False, device="cpu")
    monkeypatch.undo()
    assert seen == [(2 * scn.K, 2 * scn.K)] * scn.T
    rd = run_cell(scn, Q, "bisection-lp", quick=False, device="cpu")
    assert len(rw.result.logs) == len(rd.result.logs) == scn.T
    for k in rd.result.params:
        np.testing.assert_allclose(rw.result.params[k].numpy(),
                                   rd.result.params[k].numpy(), atol=1e-3)


def test_async_sweep_axes_with_replicates(narrow):
    """alpha x deadline-quantile x depth through ``run_grid_batched``
    with R = 2: JAX's names, finite ci95 columns, participation in
    (0, 1]."""
    base = tiny("async-q50", T=3)
    scns = async_scenarios(alphas=(0.0, 1.0), quantiles=(0.5,),
                           depths=(1, 2), base=base)
    jnames = [s.name for s in jasync_scenarios(
        alphas=(0.0, 1.0), quantiles=(0.5,), depths=(1, 2))]
    assert [s.name for s in scns] == jnames == [
        "async-a0-q0.5-d1", "async-a0-q0.5-d2", "async-a1-q0.5-d1",
        "async-a1-q0.5-d2"]
    res = run_grid_batched(scns, {"mixed": Q}, POWER, quick=False,
                           device="cpu", replicates=2)
    assert len(res) == 4
    for r in res:
        s = r.summary
        assert s["replicates"] == 2.0
        for key in ("final_acc", "total_latency_s", "mean_staleness",
                    "effective_participation", "mean_straggler_gap_s"):
            assert np.isfinite(s[key]) and np.isfinite(s[key + "_ci95"]), key
        assert 0.0 < s["effective_participation"] <= 1.0


def test_packed_async_replicates_keep_replicate0(narrow):
    """``async-q50-wire`` through ``run_grid_batched`` with R = 2: the
    packed plane loops the replicates and stacks their planes (uint32,
    through int32 views) into an [R, K, ...] buffer; replicate 0 is the
    unreplicated run bit for bit, staleness and drops included, and
    replicate 1 is another trajectory."""
    from repro_torch.kernels.ops import MixedResWire

    scn = tiny("async-q50-wire", T=4)
    rep, = run_grid_batched([scn], {"mixed": Q}, POWER, quick=False,
                            device="cpu", replicates=2)
    one, = run_grid_batched([scn], {"mixed": Q}, POWER, quick=False,
                            device="cpu")
    assert run_mismatches(rep.result[0], one.result) == []
    for g, w in zip(rep.result[0].logs, one.result.logs, strict=True):
        assert (g.mean_staleness, g.dropped_uploads,
                g.effective_participation) == (
            w.mean_staleness, w.dropped_uploads, w.effective_participation)
    assert run_mismatches(rep.result[1], one.result) != []
    eng = make_engine(scn, Q, "bisection-lp", device="cpu")
    st = eng.start_replicated_run(2)
    work = eng.train_round_replicated(st, 1)
    assert isinstance(st.async_clock.payload, MixedResWire)
    eng.complete_round_replicated_async(
        st, work, np.full((2, scn.K), 1.0) + np.arange(scn.K))
    buf = st.async_clock.buffer
    assert buf.signs.dtype == buf.hi.dtype == buf.codes.dtype == torch.uint32
    assert buf.signs.shape[:2] == (2, scn.K)


def test_depth_axis_changes_drop_accounting(narrow):
    """Depth 0 drops every miss: more dropped uploads than a deep
    buffer, and no staleness."""
    base = tiny("async-q50", T=4)
    runs = {depth: run_grid_batched(
        [dataclasses.replace(base, name=f"d{depth}", max_staleness=depth)],
        {"mixed": Q}, POWER, quick=False, device="cpu")[0].summary
        for depth in (0, 4)}
    assert runs[0]["dropped_uploads"] > runs[4]["dropped_uploads"]
    assert runs[0]["mean_staleness"] == 0.0


# ----------------------------------------------------- against JAX
@pytest.mark.parametrize("plane", ["dense", "packed"])
def test_async_rounds_track_jax_on_the_same_latencies(plane):
    """Both engines from JAX's init and data, fed JAX's solve latencies
    each round: ``round_s``, the arrivals and the weights exactly
    (the clock runs on the same host inputs), the fresh masks equal, the
    bits within a dbar flip, params by ``assert_trajectory_close``."""
    K, T, L, n_train, n_test = 5, 4, 2, 240, 40
    fl = dict(L=L, T=T, batch_size=8, alpha=0.01, eval_every=1, seed=0)
    stale = dict(deadline_quantile=0.5, alpha=0.5, max_staleness=2)
    jfull = jmake_data(n_train + n_test, hw=12, seed=0)
    jtrain = dataclasses.replace(jfull, x=jfull.x[:n_train],
                                 y=jfull.y[:n_train])
    jtest = dataclasses.replace(jfull, x=jfull.x[n_train:],
                                y=jfull.y[n_train:])
    jeng = JEngine(jtrain, jtest, jdirichlet(jtrain, K, seed=0),
                   JCfg(**NARROW), JMixed(0.2, 10), JBisection(),
                   jmake_channel(JChanCfg(M=4, N=2, K=K), seed=0), JFL(**fl),
                   engine=JEngineConfig(
                       fused=True, wire=JWire(plane=plane), async_mode=True,
                       participation=0.8, staleness=JStaleness(**stale)))
    full = make_image_classification(n_train + n_test, hw=12, seed=0)
    train = dataclasses.replace(full, x=full.x[:n_train], y=full.y[:n_train])
    test = dataclasses.replace(full, x=full.x[n_train:], y=full.y[n_train:])
    teng = VectorizedFLEngine(
        train, test, partition_dirichlet(train, K, seed=0),
        PaperCNNConfig(**NARROW), MixedResolutionQuantizer(0.2, 10),
        BisectionLPPowerControl(),
        make_channel(CFmMIMOConfig(M=4, N=2, K=K), seed=0), FLConfig(**fl),
        engine=EngineConfig(fused=True, wire=WirePath(plane=plane),
                            async_mode=True, participation=0.8,
                            staleness=StalenessConfig(**stale)),
        device="cpu",
        init_params=params_from_jax({k: np.asarray(v)
                                     for k, v in jeng.params.items()}))
    js, ts = jeng.start_run(), teng.start_run()
    d, flips, arrived = teng.d, 0, 0
    for t in range(1, T + 1):
        jw, tw = jeng.train_round(js, t), teng.train_round(ts, t)
        np.testing.assert_array_equal(jw.active, tw.active)
        np.testing.assert_array_equal(jw.participating, tw.participating)
        dbar = lambda b: np.rint((np.asarray(b, np.float64) - d - 32) / 9)
        diff = np.abs(dbar(jw.bits_np) - dbar(tw.bits_np))
        assert np.all(diff <= 2), diff
        flips += int(diff.sum())
        _, pu = jeng.solve_uplink_host(js.chan, jw.bits_np, jw.active)
        jstep = jadvance(js.async_clock.in_flight, js.async_clock.remaining_s,
                         js.async_clock.staleness, pu[None], jw.active[None],
                         jw.participating[None], jeng.rho,
                         jeng.engine_cfg.staleness)
        tstep = advance_async_clock(
            ts.async_clock.in_flight, ts.async_clock.remaining_s,
            ts.async_clock.staleness, pu[None], tw.active[None],
            tw.participating[None], teng.rho, teng.engine_cfg.staleness)
        for f in ("round_s", "arrived", "w_fresh", "w_buf"):
            assert np.array_equal(getattr(jstep, f), getattr(tstep, f)), f
        ji = jeng.complete_round_async(js, jw, pu)
        ti = teng.complete_round_async(ts, tw, pu)
        assert np.array_equal(ji.round_uplink_s, ti.round_uplink_s)
        assert np.array_equal(ji.n_arrived, ti.n_arrived)
        arrived += int(ti.n_arrived[0])
    assert arrived > 0
    assert_trajectory_close({k: v.numpy() for k, v in ts.params.items()},
                            {k: np.asarray(v) for k, v in js.params.items()},
                            flips, T, L, fl["alpha"])


# -------------------------------------------------------- refusals
@pytest.mark.parametrize("case,match", [
    ("signplane", "packed"), ("unfused", "fused"),
    ("cohorts", "lockstep")])
def test_async_refusals(narrow, case, match):
    """As JAX's engine: async rounds refuse the signplane plane, the
    exact mode and cohort streaming."""
    scn = tiny("async-q50")
    if case == "signplane":
        scn = dataclasses.replace(scn, aggregation="signplane")
    elif case == "unfused":
        scn = dataclasses.replace(scn, fused=False, aggregation="dense")
    else:
        scn = dataclasses.replace(scn, aggregation="wire", cohort_size=2)
    with pytest.raises(ValueError, match=match):
        make_engine(scn, Q, "bisection-lp", device="cpu")


@pytest.mark.parametrize("name", ["async-q50", "async-churn",
                                  "async-sync-reduction"])
def test_async_scenarios_as_jax_registers_them(name):
    scn, jscn = get_scenario(name), jget_scenario(name)
    fields = [f.name for f in dataclasses.fields(jscn)
              if f.name != "description"]
    assert {f: getattr(scn, f) for f in fields} \
        == {f: getattr(jscn, f) for f in fields}
    cfg, jcfg = scn.engine_config(), jscn.engine_config()
    assert dataclasses.astuple(cfg.staleness) \
        == dataclasses.astuple(jcfg.staleness)
    assert cfg.async_active == jcfg.async_active == scn.async_active
    wire = get_scenario("async-q50-wire")
    assert wire.aggregation == "wire" and wire.async_active

"""User churn and Monte-Carlo channel redraws in the port's engine
against the JAX engine, on the packed, signplane and dense planes (the
fused step) and in the exact mode.

Both engines run from JAX's init on the same data, shards, channel and
streams (a narrow paper CNN: 12x12 inputs, 8 filters, 16 dense units;
K=6 users, L=2 local steps of batch 8, T=4 rounds, M=4 APs of N=2
antennas).  Under churn (participation 0.7) each round draws a fresh
active set from ``default_rng((seed, 0x5EED))``, never empty; the
weights are ``rho * active`` renormalized in float64; absent users'
quantizer state is frozen, their bits are 0 and the power is solved on
the active users' sub-channel.  A redraw replaces the channel by
``make_channel(cfg, seed=channel_seed + t)`` when ``(t - 1) % every ==
0`` past round 1.  The masks and channels must be identical; the
logs and params are held to PERF.md §2's limits (``dbar`` within 2,
bits exact on ``dbar``, latency within 1e-3 relative, accuracy within
2 test samples, params within 1e-4 until a decision flips).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_trajectory_close, churn_rounds, same_bits

from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.core import quantize as jq
from repro.core.channel import CFmMIMOConfig as JChanCfg
from repro.core.channel import make_channel as jmake_channel
from repro.core.power import BisectionLPPowerControl as JBisection
from repro.data import make_image_classification as jmake_data
from repro.data import partition_dirichlet as jdirichlet
from repro.fl.loop import FLConfig as JFL
from repro.kernels import WirePath as JWire
from repro.sim import EngineConfig as JEngineConfig
from repro.sim import VectorizedFLEngine as JEngine
from repro.sim import get_scenario as jget_scenario
from repro.sim.engine import _subchannel as jsubchannel
from repro.sim.scenarios import build_problem as jbuild_problem
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.core.power import BisectionLPPowerControl
from repro_torch.core.quantize import make_quantizer
from repro_torch.data import make_image_classification, partition_dirichlet
from repro_torch.fl.cnn import params_from_jax
from repro_torch.fl.loop import FLConfig
from repro_torch.kernels import WirePath
from repro_torch.sim import (EngineConfig, VectorizedFLEngine, get_scenario,
                             make_engine)
from repro_torch.sim.engine import _subchannel
from repro_torch.sim.scenarios import build_problem

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
K, T, L, BATCH, N_TRAIN, N_TEST, LAM, B = 6, 4, 2, 8, 240, 40, 0.2, 10
FL = dict(L=L, T=T, batch_size=BATCH, alpha=0.01, eval_every=1, seed=0)
CHAN_FIELDS = ("beta", "pilot", "gamma", "A_bar", "B_bar", "B_tilde", "I_M")
# (plane, fused): the three planes of the fused step, and the exact mode
MODES = {"packed": ("packed", True), "signplane": ("signplane", True),
         "dense": ("dense", True), "exact": ("dense", False)}
KNOBS = {"churn": dict(participation=0.7),
         "redraw": dict(redraw_channel_every=1, channel_seed=3)}


@pytest.fixture(scope="module")
def problems():
    jfull = jmake_data(N_TRAIN + N_TEST, hw=12, seed=0)
    jtrain = dataclasses.replace(jfull, x=jfull.x[:N_TRAIN],
                                 y=jfull.y[:N_TRAIN])
    jtest = dataclasses.replace(jfull, x=jfull.x[N_TRAIN:],
                                y=jfull.y[N_TRAIN:])
    jprob = (jtrain, jtest, jdirichlet(jtrain, K, seed=0), JCfg(**NARROW),
             jmake_channel(JChanCfg(M=4, N=2, K=K), seed=0))
    full = make_image_classification(N_TRAIN + N_TEST, hw=12, seed=0)
    train = dataclasses.replace(full, x=full.x[:N_TRAIN],
                                y=full.y[:N_TRAIN])
    test = dataclasses.replace(full, x=full.x[N_TRAIN:], y=full.y[N_TRAIN:])
    tprob = (train, test, partition_dirichlet(train, K, seed=0),
             PaperCNNConfig(**NARROW),
             make_channel(CFmMIMOConfig(M=4, N=2, K=K), seed=0))
    return jprob, tprob


def engines(problems, mode, knobs, quantizer=("mixed-resolution",
                                              {"lambda_": LAM, "b": B})):
    jprob, tprob = problems
    plane, fused = MODES[mode]
    name, kw = quantizer
    jeng = JEngine(*jprob[:4], jq.make_quantizer(name, **kw), JBisection(),
                   jprob[4], JFL(**FL),
                   engine=JEngineConfig(fused=fused, wire=JWire(plane=plane),
                                        **knobs))
    teng = VectorizedFLEngine(
        *tprob[:4], make_quantizer(name, **kw), BisectionLPPowerControl(),
        tprob[4], FLConfig(**FL),
        engine=EngineConfig(fused=fused, wire=WirePath(plane=plane),
                            **knobs),
        device="cpu",
        init_params=params_from_jax({k: np.asarray(v)
                                     for k, v in jeng.params.items()}))
    assert teng.engine_cfg.effective_fused == jeng.engine_cfg.effective_fused
    return jeng, teng


def step(eng, state, t):
    work = eng.train_round(state, t)
    uplink, per_user = eng.solve_uplink_host(state.chan, work.bits_np,
                                             work.active)
    eng.finish_round(state, work, uplink, per_user_s=per_user)
    return work, per_user


def dbar_of(bits, d):
    return np.rint((np.asarray(bits, np.float64) - d - 32.0) / (B - 1))


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("mode", list(MODES))
def test_run_matches_jax_engine(problems, mode, knob):
    """T rounds of both engines: identical active masks and channels
    every round; bits, latency, accuracy and params within the limits;
    absent users' bits and latencies 0 in both."""
    jeng, teng = engines(problems, mode, KNOBS[knob])
    js, ts = jeng.start_run(), teng.start_run()
    d, flips, absent, chans = teng.d, 0, 0, set()
    for t in range(1, T + 1):
        jw, jlat = step(jeng, js, t)
        tw, tlat = step(teng, ts, t)
        np.testing.assert_array_equal(tw.active, jw.active)
        off = tw.active == 0
        absent += int(off.sum())
        for f in CHAN_FIELDS:
            np.testing.assert_array_equal(getattr(ts.chan, f),
                                          getattr(js.chan, f))
        chans.add(float(ts.chan.A_bar.sum()))
        assert np.all(tw.bits_np[off] == 0) and np.all(tlat[off] == 0)
        assert np.all(np.asarray(jw.bits_np)[off] == 0)
        on = ~off
        jd, td = dbar_of(jw.bits_np[on], d), dbar_of(tw.bits_np[on], d)
        assert np.all(np.abs(jd - td) <= 2), (jd, td)
        flips += int(np.abs(jd - td).sum())
        s = np.float32(td) / np.float32(d)
        want = np.float32(d) * (np.float32(B) * s + np.float32(1.0) - s) \
            + np.float32(32.0)
        np.testing.assert_array_equal(tw.bits_np[on],
                                      want.astype(np.float64))
        jl, tl = js.logs[-1], ts.logs[-1]
        np.testing.assert_allclose(tl.uplink_latency_s, jl.uplink_latency_s,
                                   rtol=1e-3)
        np.testing.assert_allclose(tl.cum_latency_s, jl.cum_latency_s,
                                   rtol=1e-3)
        assert abs(tl.test_acc - jl.test_acc) * N_TEST <= 2 + 1e-9
        assert tl.effective_participation == jl.effective_participation
    if knob == "churn":
        assert absent > 0
    else:
        assert absent == 0 and len(chans) == T     # a new channel a round
    assert_trajectory_close(
        {k: v.numpy() for k, v in ts.params.items()},
        {k: np.asarray(v) for k, v in js.params.items()},
        flips, rounds=T, L=L, alpha=FL["alpha"])


def test_subchannel_power_solve_matches_jax(problems):
    """The active users' sub-channel and the power solved on it, exactly
    JAX's; absent users get latency 0, and the solve is that of a
    K'-user problem on the sub-channel alone."""
    jeng, teng = engines(problems, "dense", KNOBS["churn"])
    jchan, chan = problems[0][4], problems[1][4]
    bits = np.random.default_rng(5).uniform(1e5, 1e6, K)
    for active in ([1, 0, 1, 1, 0, 1], [0, 0, 0, 1, 0, 0], [1] * K):
        active = np.asarray(active, np.float64)
        idx = np.flatnonzero(active)
        sub, jsub = _subchannel(chan, idx), jsubchannel(jchan, idx)
        assert sub.cfg.K == jsub.cfg.K == len(idx)
        for f in CHAN_FIELDS:
            np.testing.assert_array_equal(getattr(sub, f), getattr(jsub, f))
        b = bits * active
        got = teng.solve_uplink_host(chan, b, active)
        want = jeng.solve_uplink_host(jchan, b, active)
        assert got.straggler_s == want.straggler_s
        np.testing.assert_array_equal(got.latencies, want.latencies)
        assert np.all(got.latencies[active == 0] == 0.0)
        alone = BisectionLPPowerControl().solve(sub, np.maximum(b[idx], 1.0))
        assert got.straggler_s == alone.straggler_latency


@pytest.mark.parametrize("mode", ["dense", "exact"])
def test_laq_state_of_absent_users_is_frozen(problems, mode):
    """LAQ under churn: each round's deltas through JAX's quantizer with
    JAX's freeze (``jnp.where`` on the active mask): the port's state
    ``last_sent`` and ``ptr`` exact, energies within 1e-6 (their sums
    run in another order), absent users' rows bit for bit what they
    were before the round, and the update exact."""
    _, teng = engines(problems, mode, KNOBS["churn"],
                      quantizer=("laq", {"b": 4, "xi": 0.5}))
    jquant = jq.make_quantizer("laq", b=4, xi=0.5)
    jstate = jquant.init_batched_state(K, teng.d)
    state = teng.start_run()
    local = teng._batched_local if mode == "dense" else teng._per_user_local
    absent = 0
    for t in range(1, T + 1):
        replay = dataclasses.replace(state, rng=copy_rng(state.rng),
                                     part_rng=copy_rng(state.part_rng))
        xs, ys = teng.draw_minibatches(replay)
        active = teng._draw_active(replay.part_rng)
        before = [s.clone() for s in state.qstate]
        with torch.no_grad():
            flat = local(state.params, xs, ys)
        work = teng.train_round(state, t)
        np.testing.assert_array_equal(work.active, active)
        jres, jnew = jquant.batched(jnp.asarray(flat.numpy()), jstate)
        on = jnp.asarray(active > 0)
        jstate = type(jstate)(*(
            jnp.where(on.reshape((K,) + (1,) * (n.ndim - 1)), n, o)
            for n, o in zip(jnew, jstate)))
        for a, b in zip(state.qstate[::2], jstate[::2]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(state.qstate.energies.numpy(),
                                   np.asarray(jstate.energies), rtol=1e-6)
        off = np.flatnonzero(active == 0)
        absent += len(off)
        for old, new in zip(before, state.qstate):
            assert same_bits(new[off], old[off])
        np.testing.assert_array_equal(
            work.bits_np, np.asarray(jres.bits, np.float64) * active)
    assert absent > 0


def copy_rng(rng):
    out = np.random.default_rng()
    out.bit_generator.state = rng.bit_generator.state
    return out


def test_active_sets_are_never_empty_and_match_jax(problems):
    """At participation 0.05 over K=6 most draws are empty, and the rule
    activates one user drawn from the same stream: 400 draws identical
    to JAX's, none empty, most of one user."""
    knobs = dict(participation=0.05)
    jeng, teng = engines(problems, "dense", knobs)
    jr = np.random.default_rng((0, 0x5EED))
    tr = teng.start_run().part_rng
    masks = np.stack([teng._draw_active(tr) for _ in range(400)])
    want = np.stack([jeng._draw_active(jr) for _ in range(400)])
    np.testing.assert_array_equal(masks, want)
    counts = masks.sum(axis=1)
    assert counts.min() >= 1 and np.mean(counts == 1) > 0.5
    for active in masks[:20]:
        w = teng._round_weights(active)
        np.testing.assert_array_equal(w, jeng._round_weights(active))
        assert np.all(w[active == 0] == 0) and abs(w.sum() - 1) < 1e-12


@pytest.mark.parametrize("plane", ["packed", "signplane", "laq"])
def test_churn_rounds_helper_on_cpu(plane):
    """``churn_rounds`` (what the GPU tests and ``chip_smoke.py`` run on
    the card) on the CPU's plain path: absent users' bits, latencies
    and LAQ state checked each round; nothing reaches the kernel
    wrappers here."""
    agg = {"packed": "wire", "laq": "dense"}.get(plane, plane)
    scn = dataclasses.replace(get_scenario("churn-0.7"), aggregation=agg,
                              K=6, T=3, n_train=240, n_test=40,
                              batch_size=8, L=1, M=4, N=2, eval_every=1)
    q = ("laq", {"b": 4, "xi": 0.5}) if plane == "laq" \
        else ("mixed-resolution", {"lambda_": LAM, "b": B})
    eng = make_engine(scn, q, "bisection-lp", device="cpu")
    rounds = list(churn_rounds(eng, scn.T))
    assert len(rounds) == scn.T
    assert sum(eng.K - info["active"] for _, _, info in rounds) > 0
    assert all(info["calls"] == {} for _, _, info in rounds)


@pytest.mark.parametrize("name", ["churn-0.7", "monte-carlo-channel"])
def test_new_scenarios_registered_as_jax(name):
    a, b = dataclasses.asdict(jget_scenario(name)), dataclasses.asdict(
        get_scenario(name))
    assert a == b
    jcfg, tcfg = jget_scenario(name).engine_config(), \
        get_scenario(name).engine_config()
    for f in ("fused", "participation", "redraw_channel_every",
              "channel_seed"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.wire.plane == jcfg.wire_path().plane == "dense"
    scn = dataclasses.replace(get_scenario(name).scaled(True), n_train=400,
                              n_test=80)
    jscn = dataclasses.replace(jget_scenario(name).scaled(True),
                               n_train=400, n_test=80)
    train, _, shards, _, chan = build_problem(scn)
    jtrain, _, jshards, _, jchan = jbuild_problem(jscn)
    np.testing.assert_array_equal(train.x, jtrain.x)
    for a, b in zip(shards, jshards):
        np.testing.assert_array_equal(a, b)
    for f in CHAN_FIELDS:
        np.testing.assert_array_equal(getattr(chan, f), getattr(jchan, f))


def test_quickstart_churn_sweep_on_cpu(tmp_path):
    """``examples/quickstart_torch.py``'s churn sweep through
    ``run_grid``: both quantizers' rows, a participation below 1."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" \
        / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    results = mod.sweep_demo(device="cpu", out_csv=str(tmp_path / "q.csv"))
    assert [r.cell.quantizer_label for r in results] == ["ours", "classic"]
    for r in results:
        assert 0.0 < r.summary["effective_participation"] < 1.0
        assert r.result.rounds_completed == 6
    assert (tmp_path / "q.csv").exists()

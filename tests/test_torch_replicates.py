"""The Monte-Carlo replicate axis on the port (``run_grid_batched(...,
replicates=R)``, ``VectorizedFLEngine.start_replicated_run``) against
the port's unreplicated driver, a host computation and the JAX engine.

Scenarios are cut as in ``tests/test_torch_phy_driver.py`` (K=6, T <= 4,
L=1, batch 8, a narrow paper CNN under its own dataset name, M=4 APs of
N=2 antennas, JAX's init).  The contract (DESIGN.md section 8):

* R = 1 is the unreplicated batched run bit for bit (bits, accuracy,
  mean s, params), latencies at rtol 1e-9, every ci95 0;
* replicate r's streams are JAX's: minibatches from
  ``default_rng((seed, 0x4D43, r))``, churn from
  ``default_rng((seed, 0x5EED, 0x4D43, r))``, channels from
  ``channel_seed + r * 2^20 + t``; replicate 0 keeps the unreplicated
  streams;
* R = 4 trajectories are pairwise distinct, and the summary's mean and
  ci95 columns are the host's ``np.mean`` and ``1.96 std / sqrt(R)`` of
  the per-replicate summaries;
* one replicated step call per quantizer and one solve per power spec
  a round, whatever R;
* on the packed plane (one replicate at a time, ``"map"``) replicate 0
  of R = 3 is the unreplicated run bit for bit;
* a budget-stopped replicate's params are those of its own last round
  while the track trains on.
"""
import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.sim.scenarios as jscenarios
from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.fl import cnn as jcnn
from repro.sim import get_scenario as jget_scenario
from repro.sim.metrics import REPLICATE_FIELDS as JREPLICATE_FIELDS
from repro.sim.scenarios import build_problem as jbuild_problem
from repro.sim.sweep import _make_engine as jmake_engine
import repro_torch.sim.phy_driver as tdriver
import repro_torch.sim.scenarios as tscenarios
from _torch_parity import same_bits
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.core.quantize import Quantizer, QuantResult
from repro_torch.fl import models as tmodels
from repro_torch.fl.cnn import params_from_jax
from repro_torch.sim import (REPLICATE_FIELDS, EngineConfig,
                             VectorizedFLEngine, get_scenario, make_engine,
                             run_grid, run_grid_batched, summarize_logs,
                             write_metrics_csv)

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
TINY = dict(K=6, T=3, n_train=240, n_test=40, batch_size=8, L=1, M=4, N=2,
            eval_every=1, dataset="narrow-syn")
QUANTIZERS = {"mixed": ("mixed-resolution", {"lambda_": 0.2, "b": 4}),
              "classic": ("classic", {})}
POWERS = {"ours": "bisection-lp",
          "maxsum": ("max-sum-rate", {"iters": 20})}


@pytest.fixture(scope="module")
def narrow():
    """A narrow CNN under its own dataset name in both packages, and the
    port's CNN init replaced by JAX's."""
    def jinit(cfg):
        return params_from_jax({k: np.asarray(v) for k, v in jcnn.init_cnn(
            jax.random.PRNGKey(0), JCfg(**dataclasses.asdict(cfg))).items()})

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jscenarios._DATASETS, "narrow-syn",
                   (JCfg(name="narrow", **NARROW), 10))
        mp.setitem(tscenarios._DATASETS, "narrow-syn",
                   (PaperCNNConfig(name="narrow", **NARROW), 10))
        mp.setattr(tmodels, "init_cnn", lambda gen, cfg: jinit(cfg))
        yield


def tiny(get, name, **kw):
    return dataclasses.replace(get(name), name=f"{name}-tiny",
                               **dict(TINY, **kw))


def run(scn, quantizers=QUANTIZERS, powers=POWERS, **kw):
    return run_grid_batched([scn], quantizers, powers, quick=False,
                            device="cpu", **kw)


# ------------------------------------------------------------ R = 1
@pytest.fixture(scope="module")
def parity_runs(narrow):
    scn = tiny(get_scenario, "churn-0.7", participation=0.5)
    return run(scn), run(scn, replicates=1)


def test_r1_is_the_unreplicated_run_bit_for_bit(parity_runs):
    legacy, rep1 = parity_runs
    assert len(legacy) == len(rep1) == len(QUANTIZERS) * len(POWERS)
    for rl, rr in zip(legacy, rep1):
        assert (rl.cell.quantizer_label, rl.cell.power_label) \
            == (rr.cell.quantizer_label, rr.cell.power_label)
        assert len(rr.result) == 1
        ll, lr = rl.result.logs, rr.result[0].logs
        assert len(ll) == len(lr) == TINY["T"]
        for a, b in zip(ll, lr):
            np.testing.assert_array_equal(a.bits_per_user, b.bits_per_user)
            assert a.test_acc == b.test_acc and a.mean_s == b.mean_s
            np.testing.assert_allclose(a.uplink_latency_s,
                                       b.uplink_latency_s, rtol=1e-9)
        for k in rl.result.params:
            assert same_bits(rl.result.params[k], rr.result[0].params[k]), k
        for key in ("total_latency_s", "max_p"):
            np.testing.assert_allclose(rl.summary[key], rr.summary[key],
                                       rtol=1e-9)


def test_r1_summary_is_a_point_estimate(parity_runs):
    _, rep1 = parity_runs
    for r in rep1:
        assert r.summary["replicates"] == 1.0
        for key, val in summarize_logs(r.result[0].logs).items():
            np.testing.assert_array_equal(r.summary[key], val)
            assert r.summary[key + "_ci95"] == 0.0


# ------------------------------------------------------------ R = 4
@pytest.fixture(scope="module")
def r4_run(narrow):
    return run(tiny(get_scenario, "monte-carlo-channel"),
               {"mixed": QUANTIZERS["mixed"]}, {"ours": "bisection-lp"},
               replicates=4)[0]


def test_r4_trajectories_pairwise_distinct(r4_run):
    bits = {tuple(res.logs[0].bits_per_user) for res in r4_run.result}
    assert len(bits) == 4
    uplinks = {tuple(l.uplink_latency_s for l in res.logs)
               for res in r4_run.result}
    assert len(uplinks) == 4
    finals = [torch.cat([v.reshape(-1) for v in res.params.values()])
              for res in r4_run.result]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(finals[i], finals[j])


def test_r4_mean_and_ci95_match_host_computation(r4_run):
    rows = [summarize_logs(res.logs) for res in r4_run.result]
    s = r4_run.summary
    assert s["replicates"] == 4.0
    for key in rows[0]:
        vals = np.array([row[key] for row in rows])
        np.testing.assert_array_equal(s[key], float(np.mean(vals)))
        np.testing.assert_array_equal(
            s[key + "_ci95"], float(1.96 * np.std(vals, ddof=1) / np.sqrt(4)))
    for f in ("total_latency_s", "mean_uplink_s", "p95_uplink_s"):
        assert np.isfinite(s[f]) and s[f] > 0
        assert np.isfinite(s[f + "_ci95"]) and s[f + "_ci95"] > 0
    assert 0.0 < s["max_p"] <= 1.0


def test_replicate_streams_equal_jax(narrow):
    """Per replicate, the port's minibatch and churn generators, active
    masks and channels are the JAX engine's, round after round (equal
    generator states after a round mean the same draws)."""
    scn = tiny(get_scenario, "churn-0.7", participation=0.5,
               redraw_channel_every=1, seed=3)
    q = QUANTIZERS["mixed"]
    jscn = tiny(jget_scenario, "churn-0.7", participation=0.5,
                redraw_channel_every=1, seed=3)
    jeng = jmake_engine(jscn, jbuild_problem(jscn), q, None)
    teng = make_engine(scn, q, device="cpu")
    js, ts = jeng.start_replicated_run(4), teng.start_replicated_run(4)
    fields = ("beta", "pilot", "A_bar", "B_bar", "B_tilde", "I_M")
    for t in range(1, 3):
        jw = jeng.train_round_replicated(js, t)
        tw = teng.train_round_replicated(ts, t)
        np.testing.assert_array_equal(tw.active, jw.active)
        for jr, tr in zip(js.rngs + js.part_rngs, ts.rngs + ts.part_rngs):
            assert jr.bit_generator.state == tr.bit_generator.state
        for r, (jc, tc) in enumerate(zip(js.chans, ts.chans)):
            for f in fields:
                np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert ts.chans[2].A_bar[0] != ts.chans[1].A_bar[0]


# -------------------------------------------------- dispatch counting
def counting_run(monkeypatch, R):
    calls = {"train": 0, "solve": 0}
    real_step = VectorizedFLEngine._replicated_step
    real_solver = tdriver.batched_solver

    def counting_step(self, n):
        fn = real_step(self, n)

        def wrapper(*args):
            calls["train"] += 1
            return fn(*args)
        return wrapper

    def counting_solver(ctrl):
        fn = real_solver(ctrl)

        def wrapper(*args, **kw):
            calls["solve"] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(VectorizedFLEngine, "_replicated_step",
                        counting_step)
    monkeypatch.setattr(tdriver, "batched_solver", counting_solver)
    run(tiny(get_scenario, "churn-0.7", T=2), replicates=R)
    return calls


@pytest.mark.parametrize("R", [1, 4])
def test_one_step_per_quantizer_and_one_solve_per_power_spec(
        narrow, monkeypatch, R):
    calls = counting_run(monkeypatch, R)
    assert calls == {"train": len(QUANTIZERS) * 2, "solve": len(POWERS) * 2}


# ------------------------------------------------------- wire planes
def test_packed_map_replicate0_is_the_unreplicated_run(narrow):
    """On the packed plane the replicates run one at a time ("map"):
    replicate 0 of R = 3 is the unreplicated run bit for bit."""
    scn = tiny(get_scenario, "churn-0.7", aggregation="wire")
    q = QUANTIZERS["mixed"]
    eng = make_engine(scn, q, device="cpu")
    assert eng.wire_path_spec.plane == "packed"
    rs, us = eng.start_replicated_run(3), eng.start_run()
    for t in range(1, 3):
        rw = eng.train_round_replicated(rs, t)
        uw = eng.train_round(us, t)
        np.testing.assert_array_equal(rw.bits_np[0], uw.bits_np)
        np.testing.assert_array_equal(rw.active[0], uw.active)
        assert rw.mean_s[0] == uw.mean_s
        assert not np.array_equal(rw.bits_np[1], rw.bits_np[0])
    for k, v in us.params.items():
        assert same_bits(rs.params[k][0], v), k


def test_vmap_and_map_agree_on_the_dense_plane(narrow):
    """``replicate_batching="vmap"`` (the card's default) and ``"map"``
    run the same trajectories: bits exact after a round, params within
    roundoff of the fused step (2e-4 of the largest move)."""
    scn = tiny(get_scenario, "churn-0.7")
    out = {}
    for mode in ("map", "vmap"):
        eng = make_engine(scn, QUANTIZERS["mixed"], device="cpu")
        eng.engine_cfg = dataclasses.replace(eng.engine_cfg,
                                             replicate_batching=mode)
        st = eng.start_replicated_run(3)
        w = eng.train_round_replicated(st, 1)
        out[mode] = (w.bits_np, {k: v.clone() for k, v in st.params.items()},
                     {k: v.clone() for k, v in eng.params.items()})
    np.testing.assert_array_equal(out["map"][0], out["vmap"][0])
    for k, init in out["map"][2].items():
        move = float((out["map"][1][k] - init).abs().max())
        diff = float((out["map"][1][k] - out["vmap"][1][k]).abs().max())
        assert diff <= 2e-4 * move, (k, diff, move)


class _ItemQuantizer(Quantizer):
    """A quantizer that reads a tensor's value on the host (``.item()``),
    which no vmap can batch."""
    name = "item"

    def __call__(self, delta, state=None):
        scale = float(delta.abs().max().item())
        return QuantResult(recon=delta, bits=torch.tensor(32.0 * scale),
                           aux={}), state


def test_vmap_refusal_names_map(narrow):
    scn = tiny(get_scenario, "paper-table2", M=None)
    eng = make_engine(scn, _ItemQuantizer(), device="cpu")
    eng.engine_cfg = dataclasses.replace(eng.engine_cfg,
                                         replicate_batching="vmap")
    with pytest.raises(RuntimeError, match='replicate_batching="map"'):
        eng.train_round_replicated(eng.start_replicated_run(2), 1)


# ------------------------------------------------------------ budgets
def test_budget_stopped_replicate_keeps_its_last_round(narrow):
    """With a budget between the replicates' round-2 cumulative
    latencies, some replicates stop at round 2 while the track trains
    to round 3; each stopped replicate's params are its round-2 params
    (those of a T=2 run) bit for bit."""
    scn = tiny(get_scenario, "monte-carlo-channel")
    q, p = {"mixed": QUANTIZERS["mixed"]}, {"ours": "bisection-lp"}
    probe = run(scn, q, p, replicates=4)[0]
    cum2 = np.array([res.logs[1].cum_latency_s for res in probe.result])
    budget = float(np.median(cum2))
    stopped = run(dataclasses.replace(scn, latency_budget_s=budget), q, p,
                  replicates=4)[0]
    at2 = run(dataclasses.replace(scn, T=2), q, p, replicates=4)[0]
    done = [res.rounds_completed for res in stopped.result]
    assert 2 in done and 3 in done, done
    for r, res in enumerate(stopped.result):
        want = (at2 if done[r] == 2 else probe).result[r].params
        for k in want:
            assert same_bits(res.params[k], want[k]), (r, k)


# ------------------------------------------------------- API and CSV
def test_scenario_replicates_routes_to_the_replicate_axis(narrow):
    """``monte-carlo-replicated`` is registered as in JAX, and a scenario
    that declares replicates > 1 gets the replicate axis without the
    caller passing ``replicates=``."""
    assert dataclasses.asdict(get_scenario("monte-carlo-replicated")) \
        == dataclasses.asdict(jget_scenario("monte-carlo-replicated"))
    scn = tiny(get_scenario, "monte-carlo-replicated", T=2, replicates=2)
    res = run(scn, {"classic": QUANTIZERS["classic"]},
              {"ours": "bisection-lp"})
    assert res[0].summary["replicates"] == 2.0 and len(res[0].result) == 2


def test_run_grid_passes_replicates_through(narrow, tmp_path):
    scn = tiny(get_scenario, "paper-table3", T=2)
    out = tmp_path / "rep.csv"
    res = run_grid([scn], {"classic": QUANTIZERS["classic"]},
                   {"ours": "bisection-lp"}, quick=False, phy_batched=True,
                   replicates=2, device="cpu", out_csv=str(out))
    assert res[0].summary["replicates"] == 2.0
    assert np.isfinite(res[0].summary["total_latency_s_ci95"])
    with open(out) as f:
        header = next(csv.reader(f))
    assert REPLICATE_FIELDS == JREPLICATE_FIELDS
    assert header[-len(REPLICATE_FIELDS):] == REPLICATE_FIELDS
    plain = tmp_path / "plain.csv"
    write_metrics_csv([{"scenario": "s", "quantizer": "q", "power": "p",
                        "rounds": 1.0}], str(plain))
    with open(plain) as f:
        assert "replicates" not in next(csv.reader(f))


def test_api_errors(narrow):
    scn = tiny(get_scenario, "paper-table3", T=1)
    with pytest.raises(ValueError, match="phy_batched"):
        run_grid([scn], {"classic": QUANTIZERS["classic"]}, quick=False,
                 replicates=2, device="cpu")
    eng = make_engine(dataclasses.replace(scn, fused=False),
                      QUANTIZERS["classic"], device="cpu")
    with pytest.raises(ValueError, match="fused"):
        eng.start_replicated_run(2)
    eng = make_engine(scn, QUANTIZERS["classic"], device="cpu")
    with pytest.raises(ValueError, match="at least one replicate"):
        eng.start_replicated_run(0)
    with pytest.raises(ValueError, match="replicate_batching"):
        VectorizedFLEngine(*tscenarios.build_problem(scn)[:4],
                           Quantizer(), None, None, eng.fl,
                           engine=EngineConfig(replicate_batching="pmap"),
                           device="cpu")

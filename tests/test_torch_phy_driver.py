"""The port's batched-phy grid driver (``run_grid_batched``) against the
port's host ``run_grid`` and against the JAX package's driver.

Scenarios are cut to K=6 users, T=3 rounds, L=1 local step of batch 8,
240/40 images, M=4 APs of N=2 antennas and a narrow paper CNN (12x12
inputs, 8 filters, 16 dense units), registered under a dataset name of
their own in both packages; both runs start from JAX's init.

* Against the host ``run_grid``: training is the same run (same
  engine, same streams), so bits and accuracy are exact; the uplink
  latencies agree within 2e-2 (the float32 solve) or 1e-5 (float64),
  DESIGN.md section 7's driver contract.
* Against JAX's ``run_grid_batched`` on ``churn-0.7`` and
  ``monte-carlo-channel``: the active masks and the channels the solves
  see are identical; bits exact on ``dbar`` (within 2), params within
  1e-4 until a decision flips, accuracy within 2 test samples
  (PERF.md section 2); uplinks within 2e-2 (both solve in f32).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_parity import assert_trajectory_close

import repro.sim.phy_driver as jdriver
import repro.sim.scenarios as jscenarios
from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.fl import cnn as jcnn
from repro.sim import get_scenario as jget_scenario
from repro.sim import run_grid_batched as jrun_grid_batched
import repro_torch.sim.phy_driver as tdriver
import repro_torch.sim.scenarios as tscenarios
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.fl import models as tmodels
from repro_torch.fl.cnn import params_from_jax
from repro_torch.sim import get_scenario, run_grid, run_grid_batched

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
TINY = dict(K=6, T=3, n_train=240, n_test=40, batch_size=8, L=1, M=4, N=2,
            eval_every=1, dataset="narrow-syn")
LAT_RTOL = {torch.float32: 2e-2, torch.float64: 1e-5}
B, LAM = 4, 0.2
QUANTIZERS = {"mixed": ("mixed-resolution", {"lambda_": LAM, "b": B}),
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


@pytest.fixture(scope="module")
def churn_runs(narrow):
    scn = tiny(get_scenario, "churn-0.7", participation=0.5)
    batched = run_grid_batched([scn], QUANTIZERS, POWERS, quick=False,
                               device="cpu")
    host = run_grid([scn], QUANTIZERS, POWERS, quick=False, device="cpu")
    return batched, host


def test_batched_matches_host_run_grid(churn_runs):
    """Shared-track training is the host path's run: bits and accuracy
    exact, the masked f32 solve within 2e-2 of the sub-channel host
    solve, round for round."""
    batched, host = churn_runs
    assert [(r.cell.quantizer_label, r.cell.power_label) for r in batched] \
        == [(r.cell.quantizer_label, r.cell.power_label) for r in host] \
        == [(q, p) for q in QUANTIZERS for p in POWERS]
    for rb, rh in zip(batched, host):
        assert len(rb.result.logs) == len(rh.result.logs) == TINY["T"]
        for b, h in zip(rb.result.logs, rh.result.logs):
            np.testing.assert_array_equal(b.bits_per_user, h.bits_per_user)
            assert b.test_acc == h.test_acc and b.mean_s == h.mean_s
            np.testing.assert_allclose(b.uplink_latency_s,
                                       h.uplink_latency_s,
                                       rtol=LAT_RTOL[torch.float32])
        np.testing.assert_allclose(rb.summary["total_latency_s"],
                                   rh.summary["total_latency_s"],
                                   rtol=LAT_RTOL[torch.float32])


def test_churn_bit_and_max_p(churn_runs):
    """Churn took users out (and never all of them), and every cell
    reports a physical ``max_p`` in (0, 1]."""
    batched, _ = churn_runs
    logs = batched[0].result.logs
    assert any((log.bits_per_user == 0).any() for log in logs)
    assert all((log.bits_per_user > 0).any() for log in logs)
    for r in batched:
        assert 0.0 < r.summary["max_p"] <= 1.0


def test_float64_solve_matches_host_within_1e5(narrow):
    """The parity precision: the float64 batched bisection solve within
    1e-5 of the host's scipy-LP sub-channel solve."""
    scn = tiny(get_scenario, "churn-0.7", participation=0.5)
    q, p = {"mixed": QUANTIZERS["mixed"]}, {"ours": "bisection-lp"}
    batched = run_grid_batched([scn], q, p, quick=False, device="cpu",
                               dtype=torch.float64)
    host = run_grid([scn], q, p, quick=False, device="cpu")
    np.testing.assert_allclose(
        [l.uplink_latency_s for l in batched[0].result.logs],
        [l.uplink_latency_s for l in host[0].result.logs],
        rtol=LAT_RTOL[torch.float64])


def test_run_grid_phy_batched_delegates(narrow):
    scn = tiny(get_scenario, "paper-table3", T=2)
    res = run_grid([scn], {"classic": ("classic", {})},
                   {"ours": "bisection-lp"}, quick=False, phy_batched=True,
                   device="cpu")
    assert len(res) == 1 and 0.0 < res[0].summary["max_p"] <= 1.0
    assert np.isfinite(res[0].summary["total_latency_s"])


def spy_bundles(mp, module, log):
    real = module.bundle_from_realizations

    def spy(chans, *args, **kw):
        log.append([np.asarray(c.A_bar) for c in chans])
        return real(chans, *args, **kw)
    mp.setattr(module, "bundle_from_realizations", spy)


@pytest.mark.parametrize("name,kw", [
    ("churn-0.7", dict(participation=0.5)),
    ("monte-carlo-channel", {})], ids=["churn-0.7", "monte-carlo-channel"])
def test_matches_jax_run_grid_batched(narrow, name, kw):
    """Both drivers from JAX's init: identical masks (the zero pattern of
    the bits) and identical channels in every bundle the solves see;
    bits exact on ``dbar``, accuracy within 2 test samples, params within
    1e-4 until a threshold decision flips, uplinks within 2e-2."""
    q, p = {"mixed": QUANTIZERS["mixed"]}, {"ours": "bisection-lp"}
    jbundles, tbundles = [], []
    with pytest.MonkeyPatch.context() as mp:
        spy_bundles(mp, jdriver, jbundles)
        spy_bundles(mp, tdriver, tbundles)
        jres = jrun_grid_batched([tiny(jget_scenario, name, **kw)], q, p,
                                 quick=False)[0]
        tres = run_grid_batched([tiny(get_scenario, name, **kw)], q, p,
                                quick=False, device="cpu")[0]
    # a fixed channel is stacked once; a redrawn one every round
    assert len(tbundles) == len(jbundles) \
        == (TINY["T"] if name == "monte-carlo-channel" else 1)
    for jb, tb in zip(jbundles, tbundles):
        for ja, ta in zip(jb, tb):
            np.testing.assert_array_equal(ja, ta)
    d = sum(v.numel() for v in tres.result.params.values())
    flips = 0
    for jl, tl in zip(jres.result.logs, tres.result.logs, strict=True):
        jb, tb = np.asarray(jl.bits_per_user), tl.bits_per_user
        np.testing.assert_array_equal(jb == 0, tb == 0)
        jd = np.rint((jb - d - 32.0) / (B - 1))
        td = np.rint((tb - d - 32.0) / (B - 1))
        on = tb > 0
        assert np.all(np.abs(jd - td)[on] <= 2), (jd, td)
        flips += int(np.abs(jd - td)[on].sum())
        assert abs(jl.test_acc - tl.test_acc) <= 2 / TINY["n_test"] + 1e-9
        np.testing.assert_allclose(tl.uplink_latency_s, jl.uplink_latency_s,
                                   rtol=LAT_RTOL[torch.float32])
    assert_trajectory_close(
        {k: v.numpy() for k, v in tres.result.params.items()},
        {k: np.asarray(v) for k, v in jres.result.params.items()},
        flips, TINY["T"], TINY["L"], 0.01)
    assert 0.0 < tres.summary["max_p"] <= 1.0


def test_bundle_cache_keys_on_the_realizations(narrow, monkeypatch):
    """With a fixed realization each power group's bundle is stacked
    once for the whole run; a redraw every round restacks it every
    round."""
    log = []
    spy_bundles(monkeypatch, tdriver, log)
    scn = tiny(get_scenario, "paper-table3")
    run_grid_batched([scn], {"mixed": QUANTIZERS["mixed"]}, POWERS,
                     quick=False, device="cpu")
    assert len(log) == len(POWERS)
    log.clear()
    run_grid_batched([dataclasses.replace(scn, redraw_channel_every=1)],
                     {"mixed": QUANTIZERS["mixed"]}, POWERS, quick=False,
                     device="cpu")
    assert len(log) == len(POWERS) * TINY["T"]


def test_unported_arguments_raise(narrow):
    scn = tiny(get_scenario, "paper-table3")
    q = {"classic": ("classic", {})}
    for kw in (dict(mesh=object()), dict(resilience=object()),
               dict(checkpoint_dir="ckpt")):
        with pytest.raises(NotImplementedError, match="not ported"):
            run_grid_batched([scn], q, quick=False, device="cpu", **kw)
    # async scenarios are ported: a track a (quantizer, power) cell
    res = run_grid_batched([dataclasses.replace(scn, async_mode=True,
                                                deadline_quantile=0.5)],
                           q, POWERS, quick=False, device="cpu")
    assert [r.cell.power_label for r in res] == list(POWERS)
    assert all(len(r.result.logs) == TINY["T"] for r in res)
    with pytest.raises(ValueError, match="replicates"):
        run_grid_batched([scn], q, quick=False, device="cpu", replicates=0)

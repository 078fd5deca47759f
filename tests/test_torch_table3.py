"""The paper's Table III grid on the port against the JAX package: the
port's ``run_grid`` against JAX's over a tiny ``paper-table3`` (K=4,
T=3, L=1, batch 8, M=4 APs of N=2 antennas, the dense plane as
registered) crossing {mixed-resolution, top-q, LAQ, AQUILA} with
{bisection-LP, Dinkelbach, max-sum-rate}, both runs from JAX's init;
the engine's quantizer-state threading on identical deltas; both
benchmark scripts' CSVs; and the three scenarios this slice
registers.

A *decision* is a discrete choice of a quantizer: the mixed-resolution
threshold set (``dbar``), LAQ's skip, AQUILA's ``b``, a top-q mask or
a uniform grid code.  The two packages train to deltas that differ by
f32 roundoff, so a value that sits on a decision's edge may go either
way.  The limits (PERF.md §2):

* per-user bits exact in each round while no decision the bits show
  (``dbar``, skip, ``b``) has flipped; a flipped user's bits follow the
  quantizer's formula (``dbar`` within 2).  Mixed-resolution bits are
  exact on ``dbar``: JAX's jitted step evaluates the payload formula
  with fused f32 arithmetic, up to one ulp from the formula's steps,
  which the port takes one by one;
* params within 1e-4 max|delta| while no decision flips.  A top-q mask
  or a grid code does not show in the bits; a flip there shows as
  params a grid step apart.  After any flip the runs train from
  different params and only AdaGrad's step bound holds (each element
  moves less than L * alpha a round in either run);
* cumulative latency within 1e-3 relative, accuracy within 2 test
  samples, every round.

On identical deltas the engine is exact against JAX's quantizer: the
quantizer's state (``last_sent``, ``ptr``), bits and update bit for
bit, LAQ's energies within 1e-6 relative.
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.core import quantize as jq
from repro.fl import cnn as jcnn
from repro.sim import get_scenario as jget_scenario
from repro.sim import run_grid as jrun_grid
from repro.sim.scenarios import build_problem as jbuild_problem
from repro_torch.configs.paper_cnn import CIFAR10
from repro_torch.core.quantize import unflatten_pytree
from repro_torch.fl import models as tmodels
from repro_torch.fl.cnn import params_from_jax
from repro_torch.sim import (METRIC_FIELDS, get_scenario, make_engine,
                             run_grid)
from repro_torch.sim.scenarios import build_problem

TINY = dict(aggregation="dense", K=4, T=3, n_train=160, n_test=40,
            batch_size=8, L=1, M=4, N=2, eval_every=1)
ALPHA = 0.01
QUANTIZERS = {
    "mixed-resolution": ("mixed-resolution", {"lambda_": 0.4, "b": 4}),
    "top-q": ("top-q", {"q": 0.01}),
    "laq": ("laq", {"b": 4, "xi": 0.5}),
    "aquila": ("aquila", {"b_min": 2, "b_max": 8, "tol": 0.05}),
}
POWERS = {
    "bisection-lp": "bisection-lp",
    "dinkelbach": ("dinkelbach", {"outer": 4, "inner": 15}),
    "max-sum-rate": ("max-sum-rate", {"iters": 20, "restarts": 0}),
}
NEW_SCENARIOS = ("paper-table2", "paper-table2-noniid", "hetero-data")


def tiny(get):
    return dataclasses.replace(get("paper-table3"), **TINY)


def jax_init(cfg):
    return {k: np.asarray(v) for k, v in jcnn.init_cnn(
        jax.random.PRNGKey(0), JCfg(**dataclasses.asdict(cfg))).items()}


@pytest.fixture(scope="module")
def from_jax_init():
    """The port's CNN init replaced by the JAX package's at seed 0."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodels, "init_cnn",
                   lambda gen, cfg: params_from_jax(jax_init(cfg)))
        yield


@pytest.fixture(scope="module")
def grids(from_jax_init, tmp_path_factory):
    out = tmp_path_factory.mktemp("grid")
    jres = jrun_grid([tiny(jget_scenario)], QUANTIZERS, POWERS, quick=False,
                     out_csv=str(out / "jax.csv"))
    tres = run_grid([tiny(get_scenario)], QUANTIZERS, POWERS, quick=False,
                    out_csv=str(out / "port.csv"), device="cpu")
    return jres, tres, out


def cells(grids, qlabel):
    jres, tres, _ = grids
    pairs = [(j, t) for j, t in zip(jres, tres)
             if t.cell.quantizer_label == qlabel]
    assert len(pairs) == len(POWERS)
    return pairs


def test_grid_cells_and_csv_match_jax(grids):
    jres, tres, out = grids
    assert [(r.cell.quantizer_label, r.cell.power_label) for r in tres] \
        == [(r.cell.quantizer_label, r.cell.power_label) for r in jres] \
        == [(q, p) for q in QUANTIZERS for p in POWERS]
    for j, t in zip(jres, tres):
        assert sorted(t.row()) == sorted(j.row())
        assert t.result.rounds_completed == j.result.rounds_completed == 3
    with open(out / "jax.csv") as f:
        jrows = list(csv.reader(f))
    with open(out / "port.csv") as f:
        trows = list(csv.reader(f))
    assert trows[0] == jrows[0] == ["scenario", "quantizer", "power"] \
        + METRIC_FIELDS
    assert [r[:4] for r in trows] == [r[:4] for r in jrows]


def bits_flips(qlabel, jbits, tbits, d):
    """Per-user flips of the decisions the bits show, after checking
    each user's bits against the quantizer's formula."""
    if qlabel == "mixed-resolution":
        jd = np.rint((jbits - d - 32.0) / 3)
        td = np.rint((tbits - d - 32.0) / 3)
        assert np.all(np.abs(jd - td) <= 2), (jd, td)
        s = np.float32(td) / np.float32(d)
        want = np.float32(d) * (np.float32(4) * s + np.float32(1.0) - s) \
            + np.float32(32.0)
        np.testing.assert_array_equal(tbits, want.astype(np.float64))
        return jd != td
    if qlabel == "laq":
        assert np.all((tbits == 0.0) | (tbits == 4.0 * d + 32.0)), tbits
        return (jbits == 0.0) != (tbits == 0.0)
    if qlabel == "aquila":
        b = (tbits - 32.0) / d
        assert np.all((b == np.rint(b)) & (b >= 2) & (b <= 8)), b
        return jbits != tbits
    return np.zeros(len(tbits), bool)


@pytest.mark.parametrize("qlabel", list(QUANTIZERS))
def test_round_logs_match_jax(grids, qlabel):
    for j, t in cells(grids, qlabel):
        d = 462410
        flipped = np.zeros(TINY["K"], bool)
        for jl, tl in zip(j.result.logs, t.result.logs):
            jb, tb = np.asarray(jl.bits_per_user), np.asarray(
                tl.bits_per_user)
            now = bits_flips(qlabel, jb, tb, d)
            keep = ~(flipped | now)
            if qlabel != "mixed-resolution":     # exact on dbar, above
                np.testing.assert_array_equal(tb[keep], jb[keep])
            flipped |= now
            np.testing.assert_allclose(tl.cum_latency_s, jl.cum_latency_s,
                                       rtol=1e-3)
            np.testing.assert_allclose(tl.uplink_latency_s,
                                       jl.uplink_latency_s, rtol=1e-3)
            assert abs(tl.test_acc - jl.test_acc) * TINY["n_test"] \
                <= 2 + 1e-9


@pytest.mark.parametrize("qlabel", list(QUANTIZERS))
def test_params_match_jax_while_no_decision_flips(grids, qlabel):
    init = jax_init(CIFAR10)
    pairs = cells(grids, qlabel)
    # power control does not touch training: each package's three cells
    # train alike (a reused engine starts each run from its init state)
    for j, t in pairs[1:]:
        for k in init:
            assert torch.equal(t.result.params[k],
                               pairs[0][1].result.params[k])
            np.testing.assert_array_equal(np.asarray(j.result.params[k]),
                                          np.asarray(pairs[0][0].result
                                                     .params[k]))
    j, t = pairs[0]
    flat = lambda p: np.concatenate([np.asarray(p[k], np.float64).ravel()
                                     for k in sorted(init)])
    jp, tp = flat(j.result.params), flat(
        {k: v.numpy() for k, v in t.result.params.items()})
    delta = float(np.abs(jp - flat(init)).max())
    diff = np.abs(tp - jp)
    visible = sum(int(bits_flips(qlabel, np.asarray(jl.bits_per_user),
                                 np.asarray(tl.bits_per_user), 462410).sum())
                  for jl, tl in zip(j.result.logs, t.result.logs))
    if visible == 0 and diff.max() <= 1e-4 * delta:
        return
    # a decision flipped (shown by the bits, or by elements a grid step
    # apart): only AdaGrad's step bound holds from there on
    assert diff.max() <= 2 * TINY["T"] * TINY["L"] * ALPHA, diff.max()


# LAQ at xi = 20 skips from round 2 on, so its skip path is threaded too
THREADED = dict(QUANTIZERS, **{"laq-lazy": ("laq", {"b": 4, "xi": 20.0})})


@pytest.mark.parametrize("qlabel", list(THREADED))
def test_engine_threads_quantizer_state_over_three_rounds(qlabel):
    """The port's engine over 3 rounds; each round's deltas replayed
    through JAX's quantizer with JAX's own threaded state: the engine's
    state after each round, its bits and its params agree."""
    name, kw = THREADED[qlabel]
    eng = make_engine(tiny(get_scenario), THREADED[qlabel], None,
                      device="cpu")
    skipped = 0
    jquant = jq.make_quantizer(name, **kw)
    jstate = jquant.init_batched_state(eng.K, eng.d)
    state = eng.start_run()
    w = eng._weights
    for t in range(1, 4):
        rng = np.random.default_rng()
        rng.bit_generator.state = state.rng.bit_generator.state
        replay = dataclasses.replace(state, rng=rng)
        xs, ys = eng.draw_minibatches(replay)
        before = {k: v.clone() for k, v in state.params.items()}
        with torch.no_grad():
            flat = eng._batched_local(before, xs, ys)
        work = eng.train_round(state, t)
        jres, jstate = jquant.batched(jnp.asarray(flat.numpy()), jstate)
        np.testing.assert_array_equal(work.bits_np,
                                      np.asarray(jres.bits, np.float64))
        if name == "laq":
            skipped += int(np.asarray(jres.aux["skipped"]).sum())
            for a, b in zip(state.qstate[::2], jstate[::2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_allclose(state.qstate.energies.numpy(),
                                       np.asarray(jstate.energies),
                                       rtol=1e-6)
        else:
            assert state.qstate is None and jstate is None
        # JAX's recons are the port's bit for bit, so the update is too
        recon = torch.tensor(np.asarray(jres.recon))
        upd = unflatten_pytree(torch.einsum("k,kd->d", w, recon), eng.spec)
        for k in before:
            assert torch.equal(state.params[k], before[k] + upd[k]), k
    assert skipped > 0 if qlabel == "laq-lazy" else skipped == 0
    # the engine's own initial state is untouched; a new run starts fresh
    fresh = eng.start_run().qstate
    if name == "laq":
        assert float(fresh.last_sent.abs().sum()) == 0.0
        assert int(fresh.ptr.abs().sum()) == 0
        assert fresh.last_sent.data_ptr() != eng.qstate.last_sent.data_ptr()


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_table_scripts_write_their_csvs(tmp_path, monkeypatch):
    from benchmarks import torch_table2_accuracy as t2
    from benchmarks import torch_table3_latency as t3

    monkeypatch.setitem(t3.SIZES, True, dict(K=4, T=4, L=1, n_train=160,
                                             n_test=40))
    monkeypatch.setitem(t2.SIZES, True, dict(
        K=4, T=3, L=1, batch_size=8, n_train=160,
        datasets=("cifar10-syn", "fashion-syn")))
    lines = t3.run(quick=True, device="cpu", out=str(tmp_path))
    rows = read_csv(tmp_path / "torch_table3.csv")
    assert list(rows[0]) == t3.FIELDS and len(lines) == 13
    assert [(r["quantizer"], r["power_control"]) for r in rows] == [
        (q, p) for q in QUANTIZERS
        for p in ("ours-bisection-lp", "dinkelbach", "max-sum-rate")]
    for r in rows:
        # evaluated every 4th round: a cell the budget stops earlier has
        # no accuracy, as in the JAX package's script
        assert 1 <= int(r["T_max"]) <= 4
        acc = float(r["best_acc"])
        assert 0.0 <= acc <= 1.0 if int(r["T_max"]) == 4 else np.isnan(acc)
        assert float(r["mean_bits"]) > 0 and float(r["power_s_per_round"]) > 0
    lines = t2.run(quick=True, device="cpu", out=str(tmp_path))
    rows = read_csv(tmp_path / "torch_table2.csv")
    assert list(rows[0]) == t2.FIELDS and len(lines) == 4
    assert [r["setting"] for r in rows] == [
        "cifar10-syn/iid", "cifar10-syn/noniid", "fashion-syn/iid",
        "fashion-syn/noniid"]
    for r in rows:
        assert 90.0 < float(r["rbar_pct"]) < 100.0   # b=10, s of a few %
        assert 0.0 < float(r["s_pct"]) < 100.0


@pytest.mark.parametrize("name", NEW_SCENARIOS)
def test_new_scenarios_build_as_jax(name):
    scn = dataclasses.replace(get_scenario(name).scaled(True), n_train=400,
                              n_test=80)
    jscn = dataclasses.replace(jget_scenario(name).scaled(True), n_train=400,
                               n_test=80)
    train, test, shards, cfg, chan = build_problem(scn)
    jtrain, jtest, jshards, jmodel, jchan = jbuild_problem(jscn)
    np.testing.assert_array_equal(train.x, jtrain.x)
    np.testing.assert_array_equal(test.y, jtest.y)
    assert len(shards) == len(jshards) == scn.K
    for a, b in zip(shards, jshards):
        np.testing.assert_array_equal(a, b)
    assert (chan is None) == (jchan is None) == (scn.M is None)
    if chan is not None:
        np.testing.assert_array_equal(chan.A_bar, jchan.A_bar)
    assert scn.engine_config().wire.plane == "dense"


def test_run_grid_refuses_the_unported_paths():
    """The batched phy path is ported; ``replicates`` without it is a
    ValueError as in JAX.  Async scenarios are ported too: they run
    through ``run_grid`` on the batched path, replicated or not."""
    with pytest.raises(ValueError, match="phy_batched"):
        run_grid(["paper-table3"], {"m": "mixed-resolution"},
                 device="cpu", replicates=2)
    scn = dataclasses.replace(tiny(get_scenario), async_mode=True,
                              deadline_quantile=0.5, T=2)
    for kw in (dict(phy_batched=True), dict(phy_batched=True, replicates=2)):
        res = run_grid([scn], {"m": "mixed-resolution"},
                       {"ours": "bisection-lp"}, quick=False, device="cpu",
                       **kw)
        assert len(res) == 1 and res[0].summary["rounds"] == 2.0

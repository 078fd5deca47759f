"""The engine's exact mode, the sequential loop, ``optim`` and
``lemma1_bound_realized`` of the port against the JAX package, and the
exact mode against the port's own sequential loop.

Both packages run from JAX's init on the same data, shards, channel
and minibatch stream (a narrow paper CNN: 12x12 inputs, 8 filters, 16
dense units; K=4 users, L=2 local steps of batch 8, T=3 rounds).  The
limits (PERF.md §2): per-user ``dbar`` within 2 and bits exact on the
port's own ``dbar``; params within 1e-4 while no threshold decision
flips (measured: 4.6e-6 after 3 rounds, against a largest move of
0.034), then AdaGrad's step bound; cumulative latency within 1e-3
relative; accuracy within 2 test samples.  Within the port the
exact mode is ``run_fl_sequential`` bit for bit, as the JAX contract
says (``tests/test_sim_engine.py``).
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_trajectory_close, run_mismatches,
                           same_bits)

from repro import optim as joptim
from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.core.channel import CFmMIMOConfig as JChanCfg
from repro.core.channel import make_channel as jmake_channel
from repro.core.power import BisectionLPPowerControl as JBisection
from repro.core.quantize import MixedResolutionQuantizer as JMixed
from repro.core.quantize import mixed_resolution as jmixed
from repro.data import make_image_classification as jmake_data
from repro.data import partition_dirichlet as jdirichlet
from repro.fl import cnn as jcnn
from repro.fl.loop import FLConfig as JFL
from repro.fl.loop import run_fl_sequential as jrun_sequential
from repro.sim import VectorizedFLEngine as JEngine
from repro_torch import optim as toptim
from repro_torch.configs.paper_cnn import CIFAR10, PaperCNNConfig
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.core.power import BisectionLPPowerControl
from repro_torch.core.quantize import (LAQQuantizer, MixedResolutionQuantizer,
                                       TopQQuantizer, lemma1_bound,
                                       lemma1_bound_realized,
                                       unflatten_pytree)
from repro_torch.data import make_image_classification, partition_dirichlet
from repro_torch.fl.cnn import init_cnn, params_from_jax
from repro_torch.fl.loop import (FLConfig, local_adagrad, local_delta,
                                 run_fl, run_fl_sequential)
from repro_torch.sim import EngineConfig, VectorizedFLEngine

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
K, T, L, BATCH, N_TRAIN, N_TEST, LAM, B = 4, 3, 2, 8, 160, 40, 0.2, 10
FL = dict(L=L, T=T, batch_size=BATCH, alpha=0.01, eval_every=1, seed=0)


# ------------------------------------------------------------- optim
def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "b": (scale * rng.standard_normal(11)).astype(np.float32)}


OPTS = {"adagrad": ("adagrad", dict(alpha=0.03)),
        "sgd": ("sgd", dict(lr=0.05)),
        "sgd-momentum": ("sgd", dict(lr=0.05, momentum=0.9)),
        "adam": ("adam", dict(lr=1e-3)),
        "adam-decay": ("adam", dict(lr=1e-3, weight_decay=0.01))}


@pytest.mark.parametrize("label", list(OPTS))
def test_optimizers_match_jax(label):
    """Four steps of each optimizer from the same params and gradients.
    AdaGrad and SGD run JAX's ops in JAX's order: updates, state and
    params bit for bit.  Adam's moments and count too; its bias
    corrections ``1 - b ** c`` are f32 in both, but eager jnp raises
    ``b`` to the integer count by repeated products while ``torch.pow``
    (and jitted XLA) round the power once, an ulp of ``b ** c`` apart
    (at c = 3: 0.00299692 against 0.00299698).  The subtraction from 1
    magnifies that ulp to at most ``2**-24 / (1 - 0.999) = 6e-5``
    relative, so Adam's updates are held within 1e-4 relative and its
    params within 1e-4 of the largest update."""
    name, kw = OPTS[label]
    jopt, topt = joptim.make_optimizer(name, **kw), \
        toptim.make_optimizer(name, **kw)
    p0 = tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    exact = name != "adam"
    for step in range(4):
        g = tree(10 + step, scale=0.1 * (step + 1))
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        tu, ts = topt.update({k: torch.tensor(v) for k, v in g.items()}, ts,
                             tp)
        jp, tp = joptim.apply_updates(jp, ju), toptim.apply_updates(tp, tu)
        for k in p0:
            if exact:
                np.testing.assert_array_equal(tu[k].numpy(),
                                              np.asarray(ju[k]))
                np.testing.assert_array_equal(tp[k].numpy(),
                                              np.asarray(jp[k]))
                continue
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-4, atol=0)
            np.testing.assert_allclose(
                tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                atol=1e-4 * float(np.abs(np.asarray(ju[k])).max()))
        if name == "adam":
            assert int(ts["count"]) == int(js["count"]) == step + 1
            for m in ("mu", "nu"):
                for k in p0:
                    np.testing.assert_array_equal(ts[m][k].numpy(),
                                                  np.asarray(js[m][k]))
        elif ts is not None:
            for k in p0:
                np.testing.assert_array_equal(ts[k].numpy(),
                                              np.asarray(js[k]))
        else:
            assert js is None


def test_optimizer_registry():
    assert list(toptim.OPTIMIZERS) == list(joptim.OPTIMIZERS)
    with pytest.raises(KeyError, match="unknown optimizer"):
        toptim.make_optimizer("lion")


def test_adagrad_optimizer_is_local_adagrads_step():
    """The ``adagrad`` optimizer's one step is ``local_adagrad``'s first
    step within two f32 ulps of the param plus two of ``alpha`` (the
    most a step moves an element): the optimizer takes ``-alpha * g``
    first (JAX's optim op order), the local loop ``alpha / sqrt(.)``
    first (JAX's ``fl.loop`` op order), so the steps may land an ulp
    apart and the sums with the param round apart once more."""
    cfg = PaperCNNConfig(**NARROW)
    params = init_cnn(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    xs = torch.tensor(rng.standard_normal((1, 8, 12, 12, 3)),
                      dtype=torch.float32)
    ys = torch.tensor(rng.integers(0, 10, (1, 8)))
    want = local_adagrad(params, xs, ys, 1, 0.03)
    from torch.func import grad

    from repro_torch.fl.cnn import cnn_loss
    opt = toptim.adagrad(alpha=0.03)
    upd, _ = opt.update(grad(cnn_loss)(params, xs[0], ys[0]),
                        opt.init(params))
    got = toptim.apply_updates(params, upd)
    for k in params:
        torch.testing.assert_close(got[k], want[k], rtol=2.0 ** -22,
                                   atol=2 * 2.0 ** -24 * 0.03)


# ---------------------------------------------------------- lemma 1
def test_lemma1_bound_realized_matches_jax():
    for lam in (0.0, 0.05, 0.2, 0.5, 1.0):
        for b in (2, 4, 10, 16):
            assert lemma1_bound(lam, b) == jmixed.lemma1_bound(lam, b)
            for rho in np.linspace(lam, 1.0, 7):
                got = lemma1_bound_realized(lam, b, float(rho))
                assert got == jmixed.lemma1_bound_realized(lam, b,
                                                           float(rho))
            # no gap at the threshold: eq. (9)'s low branch
            assert lemma1_bound_realized(lam, b, lam) == pytest.approx(
                max(lam / 2.0, (1.0 - lam) / (2.0 * (2 ** b - 1))))


def test_lemma1_bound_realized_bounds_the_error():
    """The realized constant bounds ``||delta - recon||_inf /
    ||delta||_inf`` for vectors with and without a gap at the
    threshold."""
    rng = np.random.default_rng(3)
    q = MixedResolutionQuantizer(0.2, 4)
    for gap in (False, True):
        x = rng.standard_normal(4096).astype(np.float32)
        if gap:                       # nothing between 0.05 and 0.9 inf
            inf = np.abs(x).max()
            mid = (np.abs(x) > 0.05 * inf) & (np.abs(x) < 0.9 * inf)
            x[mid] *= 0.01
        res, _ = q(torch.tensor(x))
        inf = float(res.aux["inf"])
        rho = float(res.aux["dw_q"]) / inf
        err = float((res.recon - torch.tensor(x)).abs().max()) / inf
        assert err <= lemma1_bound_realized(0.2, 4, rho) + 1e-6


# --------------------------------------------- runs against the JAX package
@pytest.fixture(scope="module")
def problems():
    """The same problem in both packages, and JAX's init."""
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
    init = {k: np.asarray(v) for k, v in jcnn.init_cnn(
        jax.random.PRNGKey(0), JCfg(**NARROW)).items()}
    return jprob, tprob, init


def dbar_of(bits, d):
    return np.rint((np.asarray(bits, np.float64) - d - 32.0) / (B - 1))


def bits_formula(dbar, d):
    s = np.float32(dbar) / np.float32(d)
    bits = np.float32(d) * (np.float32(B) * s + np.float32(1.0) - s) \
        + np.float32(32.0)
    return bits.astype(np.float64)


def assert_close_to_jax(tres, jres, d):
    """The round logs and params of a port run against a JAX run from
    the same init, within PERF.md §2's limits."""
    assert len(tres.logs) == len(jres.logs) == T
    flips = 0
    for jl, tl in zip(jres.logs, tres.logs):
        jd, td = dbar_of(jl.bits_per_user, d), dbar_of(tl.bits_per_user, d)
        assert np.all(np.abs(jd - td) <= 2), (jd, td)
        flips += int(np.abs(jd - td).sum())
        np.testing.assert_array_equal(tl.bits_per_user, bits_formula(td, d))
        np.testing.assert_allclose(tl.cum_latency_s, jl.cum_latency_s,
                                   rtol=1e-3)
        assert abs(tl.test_acc - jl.test_acc) * N_TEST <= 2 + 1e-9
    assert_trajectory_close(
        {k: v.numpy() for k, v in tres.params.items()},
        {k: np.asarray(v) for k, v in jres.params.items()},
        flips, rounds=T, L=L, alpha=FL["alpha"])


@pytest.fixture(scope="module")
def jax_runs(problems):
    jprob, _, _ = problems
    seq = jrun_sequential(*jprob[:4], JMixed(LAM, B), JBisection(),
                          jprob[4], JFL(**FL))
    eng = JEngine(*jprob[:4], JMixed(LAM, B), JBisection(), jprob[4],
                  JFL(**FL))
    assert not eng.engine_cfg.effective_fused
    return seq, eng.run()


@pytest.mark.parametrize("which", ["sequential", "exact"])
def test_port_run_matches_jax(problems, jax_runs, which):
    """The port's ``run_fl_sequential`` against JAX's, and the port's
    exact mode (``run_fl``'s default) against JAX's exact mode."""
    _, tprob, init = problems
    f = run_fl_sequential if which == "sequential" else run_fl
    tres = f(*tprob[:4], MixedResolutionQuantizer(LAM, B),
             BisectionLPPowerControl(), tprob[4], FLConfig(**FL),
             device="cpu", init_params=params_from_jax(init))
    jres = jax_runs[0] if which == "sequential" else jax_runs[1]
    assert_close_to_jax(tres, jres, 3610)


# ---------------------------------------------- exact mode within the port
QUANTS = {"mixed-resolution": lambda: MixedResolutionQuantizer(LAM, B),
          "laq": lambda: LAQQuantizer(b=4, xi=0.5),
          "top-q": lambda: TopQQuantizer(q=0.01)}


@pytest.mark.parametrize("qlabel", list(QUANTS))
def test_exact_mode_is_sequential_bit_for_bit(problems, qlabel):
    """The port's exact mode reproduces its ``run_fl_sequential`` bit
    for bit: every round's bits, latency, mean s and accuracy, and the
    params (LAQ's state is stacked in one, a list in the other)."""
    _, tprob, _ = problems
    runs = [f(*tprob[:4], QUANTS[qlabel](), BisectionLPPowerControl(),
              tprob[4], FLConfig(**FL), device="cpu")
            for f in (run_fl_sequential, run_fl)]
    assert run_mismatches(runs[1], runs[0]) == []


def test_exact_fold_rounds_each_weight_once_to_f32(problems):
    """The exact mode's aggregate is the left-to-right f32 fold of
    ``recon_j * f32(w_j)``, bit for bit the same fold in numpy (which
    JAX's eager ops compute): each float64 weight rounded once to f32,
    every product and sum one IEEE rounding, the first term kept as is
    (a -0.0 stays -0.0 here; the sequential loop's ``sum`` starts at 0
    and turns it to +0.0)."""
    _, tprob, _ = problems
    eng = VectorizedFLEngine(*tprob[:4], MixedResolutionQuantizer(LAM, B),
                             None, None, FLConfig(**FL), device="cpu")
    rng = np.random.default_rng(7)
    xs = torch.tensor(rng.standard_normal((K, L, BATCH, 12, 12, 3)),
                      dtype=torch.float32)
    ys = torch.tensor(rng.integers(0, 10, (K, L, BATCH)))
    w64 = rng.dirichlet(np.ones(K))
    with torch.no_grad():
        new, _, _, _ = eng._exact_step(
            eng.params, None, xs, ys, torch.tensor(w64, dtype=torch.float32))
        flat = eng._per_user_local(eng.params, xs, ys)
        recon = eng.quantizer.batched(flat)[0].recon.numpy()
    agg = recon[0] * np.float32(w64[0])
    for j in range(1, K):
        agg = agg + recon[j] * np.float32(w64[j])
    upd = unflatten_pytree(torch.tensor(agg), eng.spec)
    for k in new:
        assert same_bits(new[k], eng.params[k] + upd[k]), k


def test_fused_mode_tracks_exact_mode(problems):
    """The fused mode (users under ``vmap``, one ``einsum``) against the
    exact mode from the same init: the same ``dbar`` every round at
    this seed, and params within 2e-4 of the largest move max|delta|.
    The gap is the batched conv backward's roundoff magnified by
    AdaGrad and depends on the CPU's thread count: measured after 3
    rounds 1.33e-4 max|delta| on 1, 2 or 4 threads, 8.5e-7 on 8."""
    _, tprob, _ = problems
    init = init_cnn(torch.Generator().manual_seed(0),
                    PaperCNNConfig(**NARROW))
    make = lambda fused: VectorizedFLEngine(
        *tprob[:4], MixedResolutionQuantizer(LAM, B),
        BisectionLPPowerControl(), tprob[4], FLConfig(**FL),
        engine=EngineConfig(fused=fused), device="cpu", init_params=init)
    exact, fused = make(False).run(), make(True).run()
    for a, b in zip(exact.logs, fused.logs):
        np.testing.assert_array_equal(dbar_of(a.bits_per_user, 3610),
                                      dbar_of(b.bits_per_user, 3610))
    delta = max(float((exact.params[k] - init[k]).abs().max())
                for k in init)
    for k in init:
        diff = float((exact.params[k] - fused.params[k]).abs().max())
        assert diff <= 2e-4 * delta, (k, diff, delta)


def test_ragged_shards_fall_back_to_sequential(problems, monkeypatch):
    """A shard smaller than ``batch_size``: ``run_fl`` runs
    ``run_fl_sequential`` (each user takes ``min(batch_size, |D_j|)``)
    and builds no engine, bit for bit."""
    from repro_torch.sim import engine as tengine

    _, tprob, _ = problems
    shards = [s.copy() for s in tprob[2]]
    shards[2] = shards[2][:5]
    args = (tprob[0], tprob[1], shards, tprob[3],
            MixedResolutionQuantizer(LAM, B), None, None, FLConfig(**FL))
    seq = run_fl_sequential(*args, device="cpu")

    def refuse(*a, **kw):
        raise AssertionError("run_fl built an engine for ragged shards")
    monkeypatch.setattr(tengine, "VectorizedFLEngine", refuse)
    via = run_fl(*args, device="cpu")
    assert run_mismatches(via, seq) == []
    assert all(l.uplink_latency_s == 0.0 for l in via.logs)


def test_vmap_is_not_the_per_user_call():
    """Why the exact mode trains user by user.  The paper CNN at
    CIFAR-10 widths, K=4 users, L=2 AdaGrad steps of batch 16:
    ``torch.func.vmap`` over the users batches the conv backward
    another way than the per-user call (measured on the CPU: conv
    gradients up to 4.7e-8 apart after one step, params up to 2.0e-5
    after two AdaGrad steps, which magnify the gap through
    ``1/sqrt(G + 1e-8)``); the dense gradients and ``vmap`` over one
    user are bit for bit the per-user call."""
    from torch.func import grad, vmap

    from repro_torch.fl.cnn import cnn_loss
    params = init_cnn(torch.Generator().manual_seed(0), CIFAR10)
    rng = np.random.default_rng(0)
    xs = torch.tensor(rng.standard_normal((4, 2, 16, 32, 32, 3)),
                      dtype=torch.float32)
    ys = torch.tensor(rng.integers(0, 10, (4, 2, 16)))
    with torch.no_grad():
        one_step = vmap(lambda x, y: grad(cnn_loss)(params, x[0], y[0]))(
            xs, ys)
        per_user = [grad(cnn_loss)(params, xs[j, 0], ys[j, 0])
                    for j in range(4)]
        gap = {k: max(float((one_step[k][j] - per_user[j][k]).abs().max())
                      for j in range(4)) for k in params}
        assert gap["conv_w"] > 0.0 and gap["conv_w"] <= 1e-6, gap
        for k in ("dense1_w", "dense1_b", "dense2_w", "dense2_b"):
            assert gap[k] == 0.0, gap
        fl = lambda x, y: local_delta(params, x, y, 2, 0.03)
        batched = vmap(fl)(xs, ys)
        single = torch.stack([fl(xs[j], ys[j]) for j in range(4)])
        diff = float((batched - single).abs().max())
        assert 0.0 < diff <= 1e-4, diff
        alone = vmap(fl)(xs[:1], ys[:1])[0]
        assert torch.equal(alone.view(torch.int32),
                           single[0].view(torch.int32))


def test_fig2_script_writes_its_csv(tmp_path, monkeypatch):
    """The Fig. 2 driver at a tiny size on the CPU: the three schemes'
    rows, evaluated every 5th round, classic at 32 bits an element and
    the mixed schemes far below."""
    from benchmarks import torch_fig2_convergence as f2

    monkeypatch.setitem(f2.SIZES, True, dict(K=3, T=5, n_train=180,
                                             n_test=40))
    lines = f2.run(quick=True, device="cpu", out=str(tmp_path))
    assert [l.split(",")[0] for l in lines] == [
        "torch_fig2/classic", "torch_fig2/mixed-0.05", "torch_fig2/mixed-0.2"]
    with open(tmp_path / "torch_fig2.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == f2.FIELDS
    assert [(r["scheme"], int(r["round"])) for r in rows] == [
        (s, 5) for s in f2.SCHEMES]
    bits = {r["scheme"]: float(r["bits_per_user"]) for r in rows}
    assert bits["classic"] == 32.0 * 462410
    assert bits["mixed-0.2"] < bits["mixed-0.05"] < 0.2 * bits["classic"]
    assert "s=100.00%" in lines[0]       # classic: every element at 32 bits

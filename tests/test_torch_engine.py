"""The port's slice end to end against the JAX engine: the fused
packed-wire FL round (``VectorizedFLEngine`` with
``EngineConfig(fused=True, wire=WirePath(plane="packed"))``) on the
same data, shards, channel, minibatch stream and carried init; plus
the slice's entry points, the dispatch of the three wire planes, the
modes it does not port, and its import isolation.  The signplane and
dense planes' own parity with the JAX engine is
``tests/test_torch_signplane.py``."""
import dataclasses
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_trajectory_close

from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.core.channel import CFmMIMOConfig as JChanCfg
from repro.core.channel import make_channel as jmake_channel
from repro.core.power import BisectionLPPowerControl as JBisection
from repro.core.quantize import MixedResolutionQuantizer as JMixed
from repro.core.quantize.base import flatten_pytree as jflatten
from repro.data import make_image_classification as jmake_data
from repro.data import partition_dirichlet as jdirichlet
from repro.fl.loop import FLConfig as JFL
from repro.fl.loop import local_adagrad as jlocal_adagrad
from repro.kernels import WirePath as JWire
from repro.kernels import ops as jops
from repro.sim import EngineConfig as JEngineConfig
from repro.sim import VectorizedFLEngine as JEngine
from repro_torch import device as tdevice
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.core.power import BisectionLPPowerControl
from repro_torch.core.quantize import MixedResolutionQuantizer
from repro_torch.data import make_image_classification, partition_dirichlet
from repro_torch.fl.cnn import params_from_jax
from repro_torch.fl.loop import FLConfig, run_fl
from repro_torch.kernels import WirePath
from repro_torch.kernels import ops as tops
from repro_torch.sim import (EngineConfig, Scenario, VectorizedFLEngine,
                             get_scenario, run_cell)

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
K, T, L, BATCH, N_TRAIN, N_TEST, LAM, B = 4, 3, 2, 8, 160, 40, 0.2, 10


@pytest.fixture(scope="module")
def both_runs():
    """T rounds of both engines from one init, data, channel and
    minibatch stream."""
    jfull = jmake_data(N_TRAIN + N_TEST, hw=12, seed=0)
    jtrain = dataclasses.replace(jfull, x=jfull.x[:N_TRAIN],
                                 y=jfull.y[:N_TRAIN])
    jtest = dataclasses.replace(jfull, x=jfull.x[N_TRAIN:],
                                y=jfull.y[N_TRAIN:])
    jshards = jdirichlet(jtrain, K, seed=0)
    jchan = jmake_channel(JChanCfg(M=4, N=2, K=K), seed=0)
    fl = dict(L=L, T=T, batch_size=BATCH, alpha=0.01, eval_every=1, seed=0)
    jeng = JEngine(jtrain, jtest, jshards, JCfg(**NARROW), JMixed(LAM, B),
                   JBisection(), jchan, JFL(**fl),
                   engine=JEngineConfig(fused=True,
                                        wire=JWire(plane="packed")))
    jres = jeng.run()

    full = make_image_classification(N_TRAIN + N_TEST, hw=12, seed=0)
    train = dataclasses.replace(full, x=full.x[:N_TRAIN],
                                y=full.y[:N_TRAIN])
    test = dataclasses.replace(full, x=full.x[N_TRAIN:], y=full.y[N_TRAIN:])
    shards = partition_dirichlet(train, K, seed=0)
    chan = make_channel(CFmMIMOConfig(M=4, N=2, K=K), seed=0)
    init = params_from_jax({k: np.asarray(v)
                            for k, v in jeng.params.items()})
    teng = VectorizedFLEngine(
        train, test, shards, PaperCNNConfig(**NARROW),
        MixedResolutionQuantizer(LAM, B), BisectionLPPowerControl(), chan,
        FLConfig(**fl), engine=EngineConfig(wire=WirePath(plane="packed")),
        device="cpu", init_params=init)
    tres = teng.run()
    return jeng, jres, teng, tres, jtrain, jshards


def dbar_of(bits, d):
    return np.rint((np.asarray(bits, np.float64) - d - 32.0) / (B - 1))


def bits_formula(dbar, d):
    s = np.float32(dbar) / np.float32(d)
    bits = np.float32(d) * (np.float32(B) * s + np.float32(1.0) - s) \
        + np.float32(32.0)
    return bits.astype(np.float64)


def test_round_logs_match_jax_engine(both_runs):
    jeng, jres, teng, tres, _, _ = both_runs
    d = teng.d
    assert d == jeng.d == 3610
    assert len(tres.logs) == len(jres.logs) == T
    for jl, tl in zip(jres.logs, tres.logs):
        jd, td = dbar_of(jl.bits_per_user, d), dbar_of(tl.bits_per_user, d)
        # elements on the threshold may flip under f32 roundoff
        assert np.all(np.abs(jd - td) <= 2), (jd, td)
        np.testing.assert_array_equal(tl.bits_per_user,
                                      bits_formula(td, d))
        np.testing.assert_allclose(tl.cum_latency_s, jl.cum_latency_s,
                                   rtol=1e-3)
        assert abs(tl.test_acc - jl.test_acc) * N_TEST <= 2 + 1e-9


def test_params_match_jax_engine(both_runs):
    """Params within 1e-4 after T rounds when no element's threshold
    decision flipped between the runs (none flips at this seed)."""
    jeng, jres, _, tres, _, _ = both_runs
    flips = int(sum(np.abs(dbar_of(jl.bits_per_user, jeng.d)
                           - dbar_of(tl.bits_per_user, jeng.d)).sum()
                    for jl, tl in zip(jres.logs, tres.logs)))
    assert_trajectory_close(
        {k: v.numpy() for k, v in tres.params.items()},
        {k: np.asarray(v) for k, v in jres.params.items()},
        flips, rounds=T, L=L, alpha=0.01)


def test_jax_round1_deltas_through_port_aggregate(both_runs):
    """JAX's own round-1 deltas through the port's encode and reduce:
    planes, header, bits, dbar and s bit-exact, the reduce within
    2 * G * eps32 * sum_g w_g * inf_g."""
    jeng, _, _, _, jtrain, jshards = both_runs
    rng = np.random.default_rng(0)               # the engines' stream
    sel = np.stack([np.stack([rng.choice(s, BATCH, replace=False)
                              for _ in range(L)]) for s in jshards])
    rows = []
    for j in range(K):
        w = jlocal_adagrad(jeng.params, jnp.asarray(jtrain.x[sel[j]]),
                           jnp.asarray(jtrain.y[sel[j]]), L, 0.01)
        rows.append(np.asarray(jflatten(jax.tree_util.tree_map(
            lambda a, b: a - b, w, jeng.params))[0]))
    flat = np.stack(rows)
    w = jeng.rho.astype(np.float32)
    jwire = jops.mixed_res_encode(jnp.asarray(flat), LAM, B,
                                  use_kernel=False)
    twire = tops.mixed_res_encode(torch.tensor(flat), LAM, B)
    for a, c in zip(twire, jwire):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    jagg, jbits, jaux = jops.mixed_res_wire_aggregate(
        jnp.asarray(flat), jnp.asarray(w), LAM, B, use_kernel=False)
    tagg, tbits, taux = tops.mixed_res_wire_aggregate(
        torch.tensor(flat), torch.tensor(w), LAM, B)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    for k in ("dbar", "s"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    tol = 2 * K * np.finfo(np.float32).eps * float(
        np.sum(w * np.asarray(jwire.head)[:, 0]))
    np.testing.assert_allclose(tagg.numpy(), np.asarray(jagg), rtol=0,
                               atol=tol)


# ------------------------------------------------------- entry points
def tiny(**kw):
    base = dict(aggregation="wire", K=4, T=2, n_train=160, n_test=40,
                batch_size=8, L=1, M=4, N=2, eval_every=1)
    base.update(kw)
    return dataclasses.replace(get_scenario("paper-table3"), **base)


def test_run_cell_on_cpu():
    res = run_cell(tiny(), ("mixed-resolution", {"lambda_": 0.2, "b": 10}),
                   "bisection-lp", quick=False, device="cpu")
    s = res.summary
    assert s["rounds"] == 2.0 and res.cell.power_label == "bisection-lp"
    assert 462410 < s["mean_bits_per_user"] < 10 * 462410
    assert np.isfinite(s["total_latency_s"]) and s["total_latency_s"] > 0
    assert 0.0 <= s["final_acc"] <= 1.0


def test_run_fl_delegates_to_engine():
    scn = tiny(M=None)
    from repro_torch.sim.scenarios import build_problem
    train, test, shards, cfg, chan = build_problem(scn)
    res = run_fl(train, test, shards, cfg, MixedResolutionQuantizer(0.2, 4),
                 None, None, FLConfig(L=1, T=1, batch_size=8, eval_every=1),
                 device="cpu")
    assert res.rounds_completed == 1 and res.logs[0].uplink_latency_s == 0.0


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card an entry point raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_cell(tiny(), MixedResolutionQuantizer(), quick=False)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw", [
    dict(async_mode=True), dict(mesh=object()), dict(resilience=object())])
def test_unported_engine_modes_raise(kw):
    """The mesh and resilience are not ported and raise; async rounds
    are ported: ``async_mode`` builds, and without a deadline it is
    JAX's sync reduction (``async_active`` False)."""
    if "async_mode" in kw:
        cfg, jcfg = EngineConfig(**kw), JEngineConfig(**kw)
        assert cfg.async_mode and jcfg.async_mode
        assert cfg.async_active is jcfg.async_active is False
        assert cfg.staleness.is_sync and jcfg.staleness.is_sync
        return
    with pytest.raises(NotImplementedError):
        EngineConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(fused=False), dict(participation=0.7),
    dict(redraw_channel_every=1)])
def test_exact_churn_and_redraw_modes_construct_and_run(kw):
    """The exact mode, churn and channel redraws build and run two
    rounds of a tiny dense paper-table3 on the CPU."""
    kw = dict(kw)
    scn = tiny(aggregation="dense", fused=kw.pop("fused", True), **kw)
    ecfg = scn.engine_config()
    assert ecfg.effective_fused == scn.fused
    from repro_torch.sim import make_engine
    res = make_engine(scn, MixedResolutionQuantizer(0.2, 10),
                      "bisection-lp", device="cpu").run()
    assert res.rounds_completed == 2
    assert all(0.0 < l.effective_participation <= 1.0 for l in res.logs)


def test_engine_config_defaults_follow_jax():
    """``EngineConfig()`` is JAX's: the exact mode on the dense plane;
    the packed and signplane planes imply the fused step."""
    cfg, jcfg = EngineConfig(), JEngineConfig()
    assert cfg.fused is False and jcfg.fused is False
    assert cfg.wire.plane == jcfg.wire_path().plane == "dense"
    for plane in ("dense", "signplane", "packed"):
        for fused in (False, True):
            assert EngineConfig(fused=fused,
                                wire=WirePath(plane=plane)).effective_fused \
                == JEngineConfig(fused=fused,
                                 wire=JWire(plane=plane)).effective_fused


@pytest.mark.parametrize("kw", [
    dict(cohort_size=8), dict(clusters=2), dict(async_mode=True),
    dict(budget=object()), dict(async_mode=True, deadline_quantile=0.5)])
def test_unported_scenario_modes_raise(kw):
    """These scenario knobs are ported now: each builds and resolves to
    the engine config JAX's scenario builds, or is refused with JAX's
    ValueError (clusters without cohorts, a budget that is not a
    LayerBudget)."""
    from repro.sim import get_scenario as jget_scenario
    agg = "wire" if "cohort_size" in kw or "clusters" in kw else "dense"
    scn = tiny(aggregation=agg, **kw)
    jscn = dataclasses.replace(jget_scenario("paper-table3"),
                               aggregation=agg, **kw)
    try:
        jcfg = jscn.engine_config()
    except ValueError:
        with pytest.raises(ValueError):
            scn.engine_config()
        return
    cfg = scn.engine_config()
    jwp = jcfg.wire_path()
    assert (cfg.wire.plane, cfg.wire.cohort_size, cfg.wire.clusters) \
        == (jwp.plane, jwp.cohort_size, jwp.clusters)
    assert (cfg.async_mode, cfg.async_active) \
        == (jcfg.async_mode, jcfg.async_active)
    assert dataclasses.astuple(cfg.staleness) \
        == dataclasses.astuple(jcfg.staleness)


def test_churn_scenario_builds_its_engine_config():
    cfg = tiny(participation=0.7, redraw_channel_every=2,
               seed=5).engine_config()
    assert (cfg.participation, cfg.redraw_channel_every,
            cfg.channel_seed, cfg.fused) == (0.7, 2, 5, True)


@pytest.mark.parametrize("plane", ["dense", "signplane", "packed"])
def test_planes_construct_and_dispatch(plane, monkeypatch):
    """Each plane builds from its scenario and routes the engine's
    aggregate to its own path on CPU tensors: the packed wire aggregate,
    the signplane identity, or the dense weighted sum of the batched
    recons."""
    from repro_torch.dist import signplane_weighted_aggregate
    from repro_torch.sim import engine as tengine
    from repro_torch.sim import make_engine

    aggregation = "wire" if plane == "packed" else plane
    scn = tiny(M=None, aggregation=aggregation)
    eng = make_engine(scn, MixedResolutionQuantizer(0.2, 10), None,
                      device="cpu")
    assert eng.wire_path_spec.plane == plane
    calls = []

    def spy(name):
        real = getattr(tengine, name)

        def wrapped(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        monkeypatch.setattr(tengine, name, wrapped)

    spy("mixed_res_wire_aggregate")
    spy("signplane_weighted_aggregate")
    flat = torch.tensor(np.random.default_rng(3).standard_normal(
        (4, eng.d)).astype(np.float32))
    agg, bits, _, _ = eng.aggregate(flat)
    q, w = eng.quantizer, eng._weights
    res, _ = q.batched(flat)
    if plane == "packed":
        assert calls == ["mixed_res_wire_aggregate"]
        want = tops.mixed_res_wire_aggregate(flat, w, q.lambda_, q.b)[0]
    elif plane == "signplane":
        assert calls == ["signplane_weighted_aggregate"]
        want = signplane_weighted_aggregate(flat, res.recon,
                                            res.aux["dw_q"], w)
    else:
        assert calls == []
        want = torch.einsum("k,kd->d", w, res.recon)
    assert torch.equal(agg, want)
    assert torch.equal(bits, res.bits)


def test_unported_model_and_replicates_raise():
    """An unported model raises NotImplementedError; the replicate axis
    is ported, and refuses the exact mode (``EngineConfig()``) as JAX
    does."""
    from repro_torch.sim.scenarios import build_problem
    with pytest.raises(NotImplementedError):
        build_problem(tiny(model="qwen3-14b"))
    eng = VectorizedFLEngine(
        *build_problem(tiny(M=None))[:4], MixedResolutionQuantizer(), None,
        None, FLConfig(L=1, T=1, batch_size=8), device="cpu")
    with pytest.raises(ValueError, match="fused"):
        eng.start_replicated_run(2)


def test_registry_matches_jax_entries():
    from repro.sim import get_scenario as jget
    for name in ("paper-table3", "signplane-wire", "fused-wire",
                 "paper-table2", "paper-table2-noniid", "hetero-data",
                 "churn-0.7", "monte-carlo-channel"):
        a, b = dataclasses.asdict(jget(name)), dataclasses.asdict(
            get_scenario(name))
        a.pop("description"), b.pop("description")
        assert a == b
    assert isinstance(get_scenario("fused-wire"), Scenario)
    assert get_scenario("paper-table3").engine_config().wire.plane == "dense"
    assert get_scenario("signplane-wire").engine_config().wire.plane == \
        "signplane"


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module and the port's benchmark scripts import
    without jax or repro."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        names += ["benchmarks.torch_table2_accuracy",
                  "benchmarks.torch_table3_latency",
                  "benchmarks.torch_fig2_convergence",
                  "benchmarks.torch_phy_solvers",
                  "benchmarks.torch_mc_replicates",
                  "benchmarks.torch_cohort_scale",
                  "benchmarks.torch_async_rounds",
                  "benchmarks.torch_layer_budget"]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print(len(names))
    """)
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_gpu_side_sources_import_neither_jax_nor_repro():
    """chip_smoke.py, the GPU tests and the port's benchmark scripts run
    where there is no jax: no import of jax or repro anywhere in them or
    in the port."""
    import ast

    root = pathlib.Path(__file__).resolve().parents[1]
    files = [root / "chip_smoke.py", root / "tests" / "test_torch_gpu.py",
             root / "tests" / "_torch_parity.py",
             root / "examples" / "quickstart_torch.py",
             *sorted((root / "tools").glob("*.py")),
             *sorted((root / "benchmarks").glob("torch_*.py")),
             *sorted((root / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, n)

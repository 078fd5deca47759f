"""Streaming cohorts and AP clusters in the port's engine (DESIGN.md
§12), on the CPU, against the port's vectorized step and the JAX
engine.

* The fold: given the same deltas, the cohort step's chunked encode and
  K3 fold through ``acc`` (any C, K % C != 0, zero weights straddling a
  cohort boundary) equals the one-shot reduce as values, with the same
  headers; C >= K is the vectorized packed step bit for bit.
* Whole rounds at C < K: the users of a cohort train under a ``vmap``
  of C users, which rounds the deltas another way than a vmap of K, so
  the runs are held to ``assert_trajectory_close`` and ``dbar`` within
  2, against the port's vectorized step and JAX's cohort run.
* AP clusters: bits bit for bit the flat cohort step's, params to f32
  roundoff; no replicate axis.
* No ``[K, d]``: a ``TorchDispatchMode`` records every op's output
  shapes during a round; the vectorized step shows a tensor holding K
  with d (or K with W), the cohort step none.

A narrow paper CNN (12x12 inputs, 8 filters, 16 dense units, d = 3610),
K = 7 users (prime: K % C != 0 for every C in 2..6), L = 2 local steps
of batch 8, no channel.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from _torch_parity import (agg_tol, assert_trajectory_close, fold_chunks,
                           run_mismatches, same_bits)

from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.core.quantize import MixedResolutionQuantizer as JMixed
from repro.data import make_image_classification as jmake_data
from repro.data import partition_iid as jpartition_iid
from repro.fl.loop import FLConfig as JFL
from repro.kernels import WirePath as JWire
from repro.sim import EngineConfig as JEngineConfig
from repro.sim import VectorizedFLEngine as JEngine
from repro.sim import get_scenario as jget_scenario
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.core.quantize import LayerBudget, MixedResolutionQuantizer
from repro_torch.data import make_image_classification, partition_iid
from repro_torch.fl.cnn import params_from_jax
from repro_torch.fl.loop import FLConfig
from repro_torch.kernels import WirePath, ops
from repro_torch.sim import (EngineConfig, StalenessConfig,
                             VectorizedFLEngine, get_scenario, run_cell)

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
K, T, L, BATCH, N_TRAIN, N_TEST, LAM, B = 7, 3, 2, 8, 280, 40, 0.2, 10
FL = dict(L=L, T=T, batch_size=BATCH, alpha=0.02, eval_every=1, seed=0)


@pytest.fixture(scope="module")
def problems():
    jfull = jmake_data(N_TRAIN + N_TEST, hw=12, seed=0)
    jtrain = dataclasses.replace(jfull, x=jfull.x[:N_TRAIN],
                                 y=jfull.y[:N_TRAIN])
    jtest = dataclasses.replace(jfull, x=jfull.x[N_TRAIN:],
                                y=jfull.y[N_TRAIN:])
    full = make_image_classification(N_TRAIN + N_TEST, hw=12, seed=0)
    train = dataclasses.replace(full, x=full.x[:N_TRAIN],
                                y=full.y[:N_TRAIN])
    test = dataclasses.replace(full, x=full.x[N_TRAIN:], y=full.y[N_TRAIN:])
    return ((jtrain, jtest, jpartition_iid(jtrain, K)),
            (train, test, partition_iid(train, K)))


def jengine(problems, wire, **kw):
    jtrain, jtest, jshards = problems[0]
    return JEngine(jtrain, jtest, jshards, JCfg(**NARROW), JMixed(LAM, B),
                   None, None, JFL(**dict(FL, **kw.pop("fl", {}))),
                   engine=JEngineConfig(wire=wire, **kw))


def engine(problems, wire, init, **kw):
    train, test, shards = problems[1]
    return VectorizedFLEngine(
        train, test, shards, PaperCNNConfig(**NARROW),
        MixedResolutionQuantizer(LAM, B), None, None,
        FLConfig(**dict(FL, **kw.pop("fl", {}))),
        engine=EngineConfig(wire=wire, **kw), device="cpu",
        init_params=init)


@pytest.fixture(scope="module")
def jax_cohort_run(problems):
    """JAX's cohort run (C = 3) and its init, which every port run
    starts from."""
    jeng = jengine(problems, JWire(plane="packed", cohort_size=3))
    init = params_from_jax({k: np.asarray(v) for k, v in jeng.params.items()})
    return jeng.run(), init


@pytest.fixture(scope="module")
def vectorized(problems, jax_cohort_run):
    return engine(problems, WirePath(plane="packed"),
                  jax_cohort_run[1]).run()


def dbar_of(bits, d):
    return np.rint((np.asarray(bits, np.float64) - d - 32.0) / (B - 1))


def flips_between(got, want, d):
    """Summed per-user |dbar| differences over the rounds; each at most
    2 (elements on the threshold flip under f32 roundoff)."""
    total = 0
    for g, w in zip(got.logs, want.logs, strict=True):
        diff = np.abs(dbar_of(g.bits_per_user, d) - dbar_of(w.bits_per_user,
                                                            d))
        assert np.all(diff <= 2), diff
        total += int(diff.sum())
    return total


def as_np(params):
    return {k: np.asarray(v) for k, v in params.items()}


# ------------------------------------------------------- the fold
def fixed_deltas(seed, U, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((U, d)).astype(np.float32)
    x[:, rng.choice(d, size=d // 64, replace=False)] *= 50.0
    x[1] = 0.0
    return torch.tensor(x)


@pytest.mark.parametrize("C", [1, 3, K - 1, K, K + 2])
def test_cohort_fold_on_identical_deltas(problems, jax_cohort_run, C):
    """The engine's cohort step fed fixed per-user deltas (a lookup in
    place of the local training): the fold equals the one-shot K3 over
    all K users as values, the headers and bits are bit for bit, and the
    zero weights of users 2-4 (straddling the boundary of C = 3) add
    nothing."""
    eng = engine(problems, WirePath(plane="packed", cohort_size=C),
                 jax_cohort_run[1])
    table = fixed_deltas(C, K, eng.d)
    # user j's minibatch is the constant j; padded users are zeros
    eng._batched_local = lambda params, xs, ys: table[
        xs[:, 0, 0, 0, 0, 0].long()]
    xs = torch.arange(K, dtype=torch.float32).reshape(K, 1, 1, 1, 1, 1) \
        .expand(K, L, BATCH, 12, 12, 3).contiguous()
    ys = torch.zeros(K, L, BATCH, dtype=torch.int64)
    w = torch.tensor([0.3, 0.1, 0.0, 0.0, 0.0, 0.4, 0.2])
    acc, head = eng._cohort_accumulate(eng.params, xs, ys, w)
    wire = ops.mixed_res_encode(table, LAM, B)
    one = ops.mixed_res_wire_reduce(wire, w, B, eng.d)
    assert torch.equal(acc, one)
    assert same_bits(head, wire.head)
    bits, _ = ops.wire_head_stats(head, B, eng.d)
    assert same_bits(bits, ops.wire_head_stats(wire.head, B, eng.d)[0])
    # the helper chip_smoke folds the card's deltas with
    acc2, head2 = fold_chunks(table, w, LAM, B, C)
    assert torch.equal(acc2, one) and same_bits(head2, wire.head)


@pytest.mark.parametrize("C", [K, K + 2])
def test_cohort_at_least_K_is_the_vectorized_step(problems, jax_cohort_run,
                                                  vectorized, C):
    """C >= K is one cohort of the K users, the same vmap batch as the
    vectorized step: bit for bit, logs and params."""
    res = engine(problems, WirePath(plane="packed", cohort_size=C),
                 jax_cohort_run[1]).run()
    assert run_mismatches(res, vectorized) == []


@pytest.mark.parametrize("C", [1, 3])
def test_cohort_below_K_tracks_vectorized_and_jax(problems, jax_cohort_run,
                                                  vectorized, C):
    """C < K against the port's vectorized step and JAX's cohort run
    (C = 3): ``dbar`` within 2 of each, params by
    ``assert_trajectory_close``."""
    jres, init = jax_cohort_run
    res = engine(problems, WirePath(plane="packed", cohort_size=C),
                 init).run()
    d = 3610
    for want in (vectorized, jres):
        flips = flips_between(res, want, d)
        assert_trajectory_close(as_np(res.params), as_np(want.params),
                                flips, T, L, FL["alpha"])


def test_churn_straddling_cohort_boundaries(problems, jax_cohort_run):
    """Partial participation draws its masks on the K axis whatever the
    cohorts; an absent user inside a cohort folds at weight 0.  The
    cohort run (C = 3) tracks the vectorized run under the same masks,
    and some round mixes present and absent users across the 3|3|1
    boundaries."""
    init = jax_cohort_run[1]
    kw = dict(participation=0.5, fl=dict(T=4))
    vec = engine(problems, WirePath(plane="packed"), init, **kw).run()
    coh = engine(problems, WirePath(plane="packed", cohort_size=3), init,
                 **kw).run()
    saw_partial = False
    for lv, lc in zip(vec.logs, coh.logs, strict=True):
        np.testing.assert_array_equal(lv.bits_per_user == 0,
                                      lc.bits_per_user == 0)
        n_active = int(np.count_nonzero(lv.bits_per_user))
        saw_partial |= 0 < n_active < K
    assert saw_partial
    flips = flips_between(coh, vec, 3610)
    assert_trajectory_close(as_np(coh.params), as_np(vec.params), flips, 4,
                            L, FL["alpha"])


@pytest.mark.parametrize("C", [3, K])
def test_replicate_axis_runs_the_cohort_step(problems, jax_cohort_run, C):
    """The replicated loop on the packed plane goes through the cohort
    step: R = 2 replicates with cohorts against the vectorized
    replicated run — bit for bit at C = K, by
    ``assert_trajectory_close`` at C = 3; the masks always equal."""
    init = jax_cohort_run[1]
    runs = []
    for wire in (WirePath(plane="packed"),
                 WirePath(plane="packed", cohort_size=C)):
        eng = engine(problems, wire, init, fl=dict(T=2))
        state = eng.start_replicated_run(2)
        works = [eng.train_round_replicated(state, t) for t in (1, 2)]
        runs.append((works, state.params))
    (w_vec, p_vec), (w_coh, p_coh) = runs
    for wv, wc in zip(w_vec, w_coh):
        np.testing.assert_array_equal(wv.active, wc.active)
        if C == K:
            np.testing.assert_array_equal(wv.bits_np, wc.bits_np)
    for r in range(2):
        got = {k: v[r].numpy() for k, v in p_coh.items()}
        want = {k: v[r].numpy() for k, v in p_vec.items()}
        if C == K:
            assert all(same_bits(p_coh[k][r], p_vec[k][r]) for k in got)
        else:
            flips = int(sum(np.abs(dbar_of(a.bits_np[r], 3610)
                                   - dbar_of(b.bits_np[r], 3610)).sum()
                            for a, b in zip(w_coh, w_vec)))
            assert_trajectory_close(got, want, flips, 2, L, FL["alpha"])


# ---------------------------------------------------------- clusters
@pytest.mark.parametrize("clusters", [2, 3])
def test_clusters_match_the_flat_cohort_step(problems, jax_cohort_run,
                                             clusters):
    """AP clusters against ``clusters=1`` (C = 3): bits bit for bit in
    every round (the same headers through the same arithmetic) and
    params to f32 roundoff; on one round from the same params the
    clustered update lies within ``4 G eps32 sum w ||x||_inf`` of the
    flat one."""
    init = jax_cohort_run[1]
    flat_eng = engine(problems, WirePath(plane="packed", cohort_size=3), init)
    hier_eng = engine(problems, WirePath(plane="packed", cohort_size=3,
                                         clusters=clusters), init)
    flat, hier = flat_eng.run(), hier_eng.run()
    for lf, lh in zip(flat.logs, hier.logs, strict=True):
        np.testing.assert_array_equal(lf.bits_per_user, lh.bits_per_user)
    for k in flat.params:
        np.testing.assert_allclose(hier.params[k].numpy(),
                                   flat.params[k].numpy(), atol=2e-4,
                                   rtol=2e-4)
    sf, sh = flat_eng.start_run(), hier_eng.start_run()
    flat_eng.train_round(sf, 1)
    hier_eng.train_round(sh, 1)
    xs, ys = flat_eng.draw_minibatches(flat_eng.start_run())
    with torch.no_grad():
        deltas = flat_eng._batched_local(init, xs, ys)
    tol = agg_tol(flat_eng._weights, deltas)
    for k in init:
        assert float((sf.params[k] - sh.params[k]).abs().max()) <= tol


def test_clusters_track_jax(problems, jax_cohort_run):
    """``clusters=2`` against JAX's clustered run from the same init:
    ``dbar`` within 2, params by ``assert_trajectory_close``."""
    init = jax_cohort_run[1]
    wire = dict(plane="packed", cohort_size=3, clusters=2)
    jres = jengine(problems, JWire(**wire)).run()
    res = engine(problems, WirePath(**wire), init).run()
    flips = flips_between(res, jres, 3610)
    assert_trajectory_close(as_np(res.params), as_np(jres.params), flips, T,
                            L, FL["alpha"])


# --------------------------------------------------- no [K, d] buffer
class ShapeLog(TorchDispatchMode):
    """Every op's output shapes while active."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [tuple(t.shape) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


def user_buffers(eng):
    """The shapes of one round's tensors that hold the user axis K
    together with d or with the wire rows W."""
    d = eng.d
    W = ops.sign_pad_len(d) // 128
    state = eng.start_run()
    with ShapeLog() as log:
        eng.train_round(state, 1)
    return [s for s in log.shapes if K in s and (d in s or W in s)]


def test_cohort_step_never_holds_K_by_d(problems, jax_cohort_run):
    """The memory contract (DESIGN.md §12): the vectorized step shows a
    [K, d] (or [K, W, ...]) tensor — the detector sees it — and the
    cohort step (C = 3), clusters or not, shows none."""
    init = jax_cohort_run[1]
    d, W = 3610, ops.sign_pad_len(3610) // 128
    assert K not in (L, BATCH, 12, 3, NARROW["conv_filters"],
                     NARROW["dense_units"], 10, 128, 8) and K not in (d, W)
    vec = engine(problems, WirePath(plane="packed"), init)
    assert user_buffers(vec), "the detector sees no [K, d] buffer"
    for wire in (WirePath(plane="packed", cohort_size=3),
                 WirePath(plane="packed", cohort_size=3, clusters=2)):
        assert user_buffers(engine(problems, wire, init)) == []


# --------------------------------------------------------- refusals
@pytest.mark.parametrize("kw", [
    dict(plane="dense", cohort_size=4), dict(plane="signplane",
                                             cohort_size=4),
    dict(plane="packed", clusters=2), dict(plane="packed", cohort_size=0),
    dict(plane="packed", clusters=0),
    dict(plane="packed", cohort_size=4,
         budget=LayerBudget.by_group(norm=(0.1, 12)))])
def test_wire_rules_match_jax(kw):
    """What JAX's WirePath refuses, the port's refuses with a
    ValueError: streaming off the packed plane, clusters without
    cohorts, sizes below 1, a non-uniform budget with streaming."""
    jkw = dict(kw)
    if "budget" in jkw:
        from repro.core.quantize import LayerBudget as JLayerBudget
        jkw["budget"] = JLayerBudget.by_group(norm=(0.1, 12))
    with pytest.raises(ValueError):
        JWire(**jkw)
    with pytest.raises(ValueError):
        WirePath(**kw)


def test_engine_refusals(problems, jax_cohort_run):
    """Clusters refuse the replicate axis; async rounds refuse cohort
    streaming (lockstep only), as in JAX."""
    init = jax_cohort_run[1]
    eng = engine(problems, WirePath(plane="packed", cohort_size=3,
                                    clusters=2), init)
    with pytest.raises(ValueError, match="replicated"):
        eng.start_replicated_run(2)
    with pytest.raises(ValueError, match="lockstep"):
        engine(problems, WirePath(plane="packed", cohort_size=3), init,
               async_mode=True, staleness=StalenessConfig(deadline_s=1.0))


# --------------------------------------------------------- scenarios
@pytest.mark.parametrize("name", ["cohort-wire", "cohort-hierarchy"])
def test_cohort_scenarios_as_jax_registers_them(name):
    """Registered with JAX's fields; the engine config resolves to JAX's
    streaming knobs; a tiny cut runs through ``run_cell`` on the CPU."""
    scn, jscn = get_scenario(name), jget_scenario(name)
    fields = [f.name for f in dataclasses.fields(jscn)
              if f.name != "description"]
    assert {f: getattr(scn, f) for f in fields} \
        == {f: getattr(jscn, f) for f in fields}
    wp, jwp = scn.engine_config().wire, jscn.engine_config().wire
    assert (wp.plane, wp.cohort_size, wp.clusters, wp.streaming) \
        == (jwp.plane, jwp.cohort_size, jwp.clusters, jwp.streaming)
    tiny = dataclasses.replace(scn, K=6, T=2, n_train=240, n_test=40,
                               batch_size=8, L=1, cohort_size=4,
                               clusters=min(scn.clusters, 2))
    res = run_cell(tiny, MixedResolutionQuantizer(LAM, B), quick=False,
                   device="cpu")
    assert res.summary["rounds"] == 2.0
    assert all(np.all(l.bits_per_user > 0) for l in res.result.logs)

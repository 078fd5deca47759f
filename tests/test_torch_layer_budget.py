"""Per-layer budgets in the port (DESIGN.md §13) against the JAX
package, on the CPU.

* The API (``BudgetRule``, ``LayerBudget``, ``Segment``) and
  ``classify_leaf`` route the same leaves to the same groups as JAX's;
  ``segments_for`` gives JAX's segments on the same params.
* Accounting: a user's bits are ``sum_seg [d_seg (b_seg s_seg + 1 -
  s_seg) + 32]``, each segment's payload the mixed-resolution payload
  of that slice alone, on the dense (``segmented_quantize``) and the
  packed (``ops.segmented_wire_aggregate``) planes, and bit for bit
  JAX's on the same deltas.
* ``LayerBudget.uniform()`` is ``budget=None`` bit for bit on both
  planes; the engine under ``layer-budget-wire``'s budget tracks JAX's
  engine (``dbar`` within 2 of each segment's, params by
  ``assert_trajectory_close``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_trajectory_close, run_mismatches,
                           same_bits, segment_bits_identity)

from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.core.quantize import LayerBudget as JLayerBudget
from repro.core.quantize import MixedResolutionQuantizer as JMixed
from repro.core.quantize import segmented_quantize as jsegmented_quantize
from repro.core.quantize.layer_budget import BudgetRule as JBudgetRule
from repro.core.quantize.layer_budget import classify_leaf as jclassify_leaf
from repro.data import make_image_classification as jmake_data
from repro.data import partition_iid as jpartition_iid
from repro.fl.loop import FLConfig as JFL
from repro.kernels import WirePath as JWire
from repro.kernels import segmented_wire_aggregate as jsegmented_wire
from repro.sim import EngineConfig as JEngineConfig
from repro.sim import VectorizedFLEngine as JEngine
from repro.sim import get_scenario as jget_scenario
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.core.quantize import (BudgetRule, ClassicQuantizer,
                                       LayerBudget, MixedResolutionQuantizer,
                                       classify_leaf, flatten_pytree,
                                       mixed_resolution_quantize,
                                       resolve_segments, segmented_quantize,
                                       validate_segments)
from repro_torch.core.quantize.layer_budget import leaves_with_path
from repro_torch.data import make_image_classification, partition_iid
from repro_torch.fl.cnn import init_cnn, params_from_jax
from repro_torch.fl.loop import FLConfig
from repro_torch.kernels import WirePath, ops
from repro_torch.sim import (EngineConfig, StalenessConfig,
                             VectorizedFLEngine, get_scenario, run_cell)

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
K, T, L, BATCH, N_TRAIN, N_TEST = 4, 3, 2, 8, 160, 40
FL = dict(L=L, T=T, batch_size=BATCH, alpha=0.02, eval_every=1, seed=0)
BUDGET = dict(norm=(0.1, 12), matmul=(0.3, 6))       # layer-budget-wire's
BUDGETS = {
    "layer-budget-wire": BUDGET,
    "default fallback": dict(norm=(0.05, 12), default=(0.3, 6)),
    "matmul only": dict(matmul=(0.4, 4)),
    "partial rules": dict(norm=BudgetRule("norm", b=14)),
}


def jbudget(spec):
    return JLayerBudget.by_group(**{
        g: (JBudgetRule(g, r.lambda_, r.b, r.s_budget)
            if isinstance(r, BudgetRule) else r) for g, r in spec.items()})


def cnn_params():
    return {k: v.numpy() for k, v in init_cnn(
        torch.Generator().manual_seed(0), PaperCNNConfig(**NARROW)).items()}


# ------------------------------------------------------------- API
def test_budget_api_matches_jax():
    """Rule validation, the uniform budget, the default fallback and
    hashability behave as JAX's."""
    for bad in (dict(group="attention"), dict(group="norm", lambda_=1.5),
                dict(group="norm", b=1), dict(group="norm", s_budget=0.0)):
        with pytest.raises(ValueError):
            JBudgetRule(**bad)
        with pytest.raises(ValueError):
            BudgetRule(**bad)
    with pytest.raises(ValueError, match="duplicate"):
        LayerBudget(rules=(BudgetRule("norm"), BudgetRule("norm")))
    with pytest.raises(TypeError):
        LayerBudget(rules=("norm",))
    assert LayerBudget.uniform().is_uniform
    lb = LayerBudget.by_group(norm=(0.1, 12), default=(0.3, 6))
    jlb = JLayerBudget.by_group(norm=(0.1, 12), default=(0.3, 6))
    assert not lb.is_uniform
    for g in ("norm", "matmul", "embed"):
        assert dataclasses.astuple(lb.rule_for(g)) \
            == dataclasses.astuple(jlb.rule_for(g))
    assert hash(lb) == hash(LayerBudget.by_group(norm=(0.1, 12),
                                                 default=(0.3, 6)))
    assert [dataclasses.astuple(r) for r in lb.rules] \
        == [dataclasses.astuple(r) for r in jlb.rules]


@pytest.mark.parametrize("tree", ["cnn", "named", "nested"])
def test_classify_leaf_matches_jax(tree):
    """Each leaf routes to JAX's group, by name and rank, in
    ``flatten_pytree``'s order; a leading stacked axis discounted by
    ``skip_leading`` keeps a stacked gain a norm."""
    trees = {
        "cnn": cnn_params(),
        "named": {"embed_tokens": np.ones((8, 4)), "ln": np.ones(4),
                  "w": np.ones((4, 4)), "lm_head": np.ones((4, 8)),
                  "vocab_bias": np.ones(8), "scale": np.float32(1.0)},
        "nested": {"z": {"inner": np.ones((2, 3))}, "a": np.ones(4),
                   "m": [np.ones((2, 2)), np.ones(3)]},
    }
    t = trees[tree]
    jleaves, _ = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(jnp.asarray, t))
    mine = leaves_with_path(t)
    assert [p for p, _ in mine] == [jax.tree_util.keystr(p)
                                    for p, _ in jleaves]
    for (path, leaf), (jpath, jleaf) in zip(mine, jleaves, strict=True):
        for skip in (0, 1):
            assert classify_leaf(path, leaf, skip) \
                == jclassify_leaf(jpath, jleaf, skip), (path, skip)


@pytest.mark.parametrize("label", list(BUDGETS))
def test_segments_match_jax(label):
    """``segments_for`` on the narrow CNN's params gives JAX's segments:
    offsets, sizes, lambda, b and group, tiling [0, d) in
    ``flatten_pytree``'s order."""
    params = cnn_params()
    segs = LayerBudget.by_group(**BUDGETS[label]).segments_for(
        params, 0.2, 10)
    jsegs = jbudget(BUDGETS[label]).segments_for(
        {k: jnp.asarray(v) for k, v in params.items()}, 0.2, 10)
    assert [tuple(s) for s in segs] == [tuple(s) for s in jsegs]
    d = int(flatten_pytree({k: torch.tensor(v)
                            for k, v in params.items()})[0].numel())
    validate_segments(segs, d)
    assert [s.stop for s in segs][-1] == d


def test_paper_cnn_segments_at_full_width():
    """``layer-budget-wire``'s budget on the paper CNN (d = 462,410): the
    six segments JAX resolves, conv_b first."""
    from repro.configs.paper_cnn import CIFAR10 as JCIFAR10
    from repro.fl.cnn import init_cnn as jinit_cnn
    from repro_torch.configs.paper_cnn import CIFAR10
    params = init_cnn(torch.Generator().manual_seed(0), CIFAR10)
    segs = LayerBudget.by_group(**BUDGET).segments_for(params, 0.2, 10)
    jsegs = JLayerBudget.by_group(**BUDGET).segments_for(
        jinit_cnn(jax.random.PRNGKey(0), JCIFAR10), 0.2, 10)
    assert [tuple(s) for s in segs] == [tuple(s) for s in jsegs]
    assert [(s.start, s.size, s.group, s.b) for s in segs] == [
        (0, 32, "norm", 12), (32, 864, "matmul", 6), (896, 64, "norm", 12),
        (960, 460800, "matmul", 6), (461760, 10, "norm", 12),
        (461770, 640, "matmul", 6)]


def test_validate_segments_refuses_gaps_and_short_cover():
    segs = LayerBudget.by_group(**BUDGET).segments_for(cnn_params(), 0.2, 10)
    d = segs[-1].stop
    with pytest.raises(ValueError, match="contiguously"):
        validate_segments(segs[1:], d)
    with pytest.raises(ValueError, match="cover"):
        validate_segments(segs, d + 1)
    with pytest.raises(ValueError, match="contiguously"):
        ops.segmented_wire_aggregate(torch.zeros(2, d), torch.ones(2),
                                     segs[::-1])


# ------------------------------------------------------ accounting
def toy(U=3, seed=0):
    """The JAX battery's toy tree (an embedding, a gain, a matmul) and
    its three segments, with [U, d] f32 deltas made by numpy."""
    tree = {"embed": np.ones((6, 8)), "ln": np.ones(8), "w": np.ones((8, 8))}
    spec = dict(embed=(0.4, 4), norm=(0.05, 12), matmul=(0.2, 8))
    segs = LayerBudget.by_group(**spec).segments_for(tree, 0.2, 10)
    d = segs[-1].stop
    x = np.random.default_rng(seed).standard_normal((U, d)).astype(np.float32)
    x[:, ::17] *= 30.0
    return segs, x


@pytest.mark.parametrize("plane", ["dense", "packed"])
def test_bits_are_the_segment_sum(plane):
    """Each segment's payload is mixed-resolution's on that slice alone
    (dense: recon and bits of ``mixed_resolution_quantize``; packed: the
    slice's own ``mixed_res_wire_aggregate``) and the bits are their
    left-to-right f32 sum, within f32 roundings of the exact sum."""
    segs, x = toy(U=4, seed=1)
    flat = torch.tensor(x)
    w = torch.tensor([0.1, 0.2, 0.3, 0.4])
    if plane == "dense":
        recon, bits, aux = segmented_quantize(flat, segs)
        for j, seg in enumerate(segs):
            for u in range(4):
                one = mixed_resolution_quantize(flat[u, seg.start:seg.stop],
                                                seg.lambda_, seg.b)
                assert same_bits(one.bits, aux["segment_bits"][u, j])
                assert same_bits(one.recon, recon[u, seg.start:seg.stop])
    else:
        agg, bits, aux = ops.segmented_wire_aggregate(flat, w, segs)
        for seg in segs:
            a, _, _ = ops.mixed_res_wire_aggregate(
                flat[:, seg.start:seg.stop].contiguous(), w, seg.lambda_,
                seg.b)
            assert same_bits(a, agg[seg.start:seg.stop])
    heads = [ops.mixed_res_encode(flat[:, s.start:s.stop], s.lambda_,
                                  s.b).head for s in segs]
    segment_bits_identity(bits, aux["segment_bits"], heads, segs)
    assert aux["dbar"].dtype == torch.int32


@pytest.mark.parametrize("plane", ["dense", "packed"])
def test_segmented_ops_match_jax(plane):
    """On the same deltas, JAX's segmented quantize / wire aggregate and
    the port's give the same bits, segment bits and dbar; the dense
    recons bit for bit, the packed aggregate bit for bit."""
    segs, x = toy(U=3, seed=2)
    jsegs = JLayerBudget.by_group(
        embed=(0.4, 4), norm=(0.05, 12), matmul=(0.2, 8)).segments_for(
        {"embed": jnp.ones((6, 8)), "ln": jnp.ones(8),
         "w": jnp.ones((8, 8))}, 0.2, 10)
    w = np.array([0.5, 0.25, 0.25], np.float32)
    if plane == "dense":
        out, jout = segmented_quantize(torch.tensor(x), segs), \
            jsegmented_quantize(jnp.asarray(x), jsegs)
    else:
        out = ops.segmented_wire_aggregate(torch.tensor(x), torch.tensor(w),
                                           segs)
        jout = jsegmented_wire(jnp.asarray(x), jnp.asarray(w), jsegs)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    for key in ("segment_bits", "dbar", "s"):
        np.testing.assert_array_equal(out[2][key].numpy(),
                                      np.asarray(jout[2][key]))


# --------------------------------------------------------- engine
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


def engines(problems, plane, budget, quantizer=None, **kw):
    """JAX's engine and the port's from JAX's init, fused, on ``plane``
    with ``budget`` (a ``by_group`` spec, "uniform" or None)."""
    (jtrain, jtest, jshards), (train, test, shards) = problems
    jb = tb = None
    if budget == "uniform":
        jb, tb = JLayerBudget.uniform(), LayerBudget.uniform()
    elif budget is not None:
        jb, tb = jbudget(budget), LayerBudget.by_group(**budget)
    jeng = JEngine(jtrain, jtest, jshards, JCfg(**NARROW), JMixed(0.2, 10),
                   None, None, JFL(**FL),
                   engine=JEngineConfig(fused=True,
                                        wire=JWire(plane=plane, budget=jb)))
    init = params_from_jax({k: np.asarray(v) for k, v in jeng.params.items()})
    teng = VectorizedFLEngine(
        train, test, shards, PaperCNNConfig(**NARROW),
        quantizer or MixedResolutionQuantizer(0.2, 10), None, None,
        FLConfig(**FL), engine=EngineConfig(
            fused=True, wire=WirePath(plane=plane, budget=tb), **kw),
        device="cpu", init_params=init)
    return jeng, teng


@pytest.mark.parametrize("plane", ["dense", "packed"])
def test_uniform_budget_is_the_global_path(problems, plane):
    """``LayerBudget.uniform()`` is ``budget=None`` bit for bit: logs and
    params of the whole run."""
    _, none = engines(problems, plane, None)
    _, uni = engines(problems, plane, "uniform")
    assert uni._segments is None
    assert run_mismatches(uni.run(), none.run()) == []


@pytest.mark.parametrize("plane", ["dense", "packed"])
def test_engine_budget_tracks_jax(problems, plane):
    """``layer-budget-wire``'s budget on both planes against JAX's
    engine from the same init: per-user dbar within 2 (the bits differ
    only through dbar), params by ``assert_trajectory_close``; and the
    budget moves the payload away from the global run's."""
    jeng, teng = engines(problems, plane, BUDGET)
    assert [tuple(s) for s in teng._segments] \
        == [tuple(s) for s in jeng._segments]
    jres, res = jeng.run(), teng.run()
    d = teng.d
    flips = 0
    for jl, tl in zip(jres.logs, res.logs, strict=True):
        diff = np.abs(np.asarray(jl.bits_per_user, np.float64)
                      - tl.bits_per_user)
        # a dbar flip in a segment moves the bits by b_seg - 1 <= 11
        assert np.all(diff <= 2 * 11 + 1e-3), diff
        flips += int(np.count_nonzero(diff > 1.0))
    assert_trajectory_close({k: v.numpy() for k, v in res.params.items()},
                            {k: np.asarray(v)
                             for k, v in jres.params.items()},
                            flips, T, L, FL["alpha"])
    _, glob = engines(problems, plane, None)
    assert not np.array_equal(res.logs[0].bits_per_user,
                              glob.run().logs[0].bits_per_user)
    assert np.all(res.logs[0].bits_per_user
                  <= d * 12 + 32 * len(teng._segments))


# -------------------------------------------------------- refusals
@pytest.mark.parametrize("case", ["quantizer", "exact", "async", "b>16"])
def test_engine_refusals(problems, case):
    """What JAX's engine refuses under a non-uniform budget: another
    quantizer, the exact mode, async rounds, and (packed) b > 16."""
    (_, _, _), (train, test, shards) = problems
    lb = LayerBudget.by_group(**BUDGET)
    q, plane, kw = MixedResolutionQuantizer(0.2, 10), "dense", dict(
        fused=True)
    match = {"quantizer": "mixed-resolution", "exact": "fused",
             "async": "async", "b>16": "16 bits"}[case]
    if case == "quantizer":
        q = ClassicQuantizer()
    elif case == "exact":
        kw = dict(fused=False)
    elif case == "async":
        kw = dict(fused=True, async_mode=True,
                  staleness=StalenessConfig(deadline_quantile=0.5))
    else:
        plane, lb = "packed", LayerBudget.by_group(norm=(0.1, 20))
    with pytest.raises(ValueError, match=match):
        VectorizedFLEngine(train, test, shards, PaperCNNConfig(**NARROW), q,
                           None, None, FLConfig(**FL),
                           engine=EngineConfig(wire=WirePath(plane=plane,
                                                             budget=lb),
                                               **kw), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(plane="signplane"), "signplane"),
    (dict(plane="packed", cohort_size=2), "cohort"),
    (dict(plane="packed", budget=object()), "LayerBudget")])
def test_wire_budget_rules_match_jax(kw, match):
    """The WirePath rules: a non-uniform budget is refused on the
    signplane plane and with streaming; a budget must be a LayerBudget;
    a uniform budget passes everywhere and resolves to None."""
    kw = dict(kw)
    kw.setdefault("budget", LayerBudget.by_group(**BUDGET))
    with pytest.raises(ValueError, match=match):
        WirePath(**kw)
    jkw = dict(kw)
    if isinstance(jkw["budget"], LayerBudget):
        jkw["budget"] = jbudget(BUDGET)
    with pytest.raises(ValueError):
        JWire(**jkw)
    lb = LayerBudget.by_group(**BUDGET)
    assert WirePath(plane="signplane",
                    budget=LayerBudget.uniform()).effective_budget is None
    assert WirePath(plane="packed", budget=lb).effective_budget is lb


# -------------------------------------------------------- scenario
def test_layer_budget_scenario_as_jax_registers_it():
    """``layer-budget-wire`` with JAX's fields and budget; the engine
    config carries it on the packed plane; a tiny cut runs through
    ``run_cell`` with six launches' worth of segments on the CNN."""
    scn, jscn = get_scenario("layer-budget-wire"), \
        jget_scenario("layer-budget-wire")
    fields = [f.name for f in dataclasses.fields(jscn)
              if f.name not in ("description", "budget")]
    assert {f: getattr(scn, f) for f in fields} \
        == {f: getattr(jscn, f) for f in fields}
    assert [dataclasses.astuple(r) for r in scn.budget.rules] \
        == [dataclasses.astuple(r) for r in jscn.budget.rules]
    wp = scn.engine_config().wire
    assert wp.plane == "packed" and wp.effective_budget is scn.budget
    tiny = dataclasses.replace(scn, K=4, T=2, n_train=160, n_test=40,
                               batch_size=8, L=1)
    res = run_cell(tiny, MixedResolutionQuantizer(0.2, 10), quick=False,
                   device="cpu")
    assert res.summary["rounds"] == 2.0
    assert np.all(res.result.logs[0].bits_per_user > 0)


def test_resolve_segments_is_segments_for():
    params = cnn_params()
    lb = LayerBudget.by_group(**BUDGET)
    assert resolve_segments(params, lb, 0.2, 10) \
        == lb.segments_for(params, 0.2, 10)

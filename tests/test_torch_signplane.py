"""Parity of the port's signplane and dense wire planes with the JAX
package, on the CPU, where the port's wrappers run the plain PyTorch
versions its CUDA kernels K4–K5 are held to on the card.

Contract and tolerances:

* K4 ``signpack``: bit for bit with the JAX Pallas kernel (interpret
  mode) and its jnp oracle, on inputs without subnormals (XLA on the
  CPU flushes them; see ``test_positive_subnormal_keeps_its_sign_bit``);
* K5 ``sign_dequant_reduce``: elementwise within
  ``G * eps32 * sum_g |scale_g|`` of the JAX kernel (the JAX kernel
  sums the peers in an einsum, the port folds them left to right);
* ``packed_sign_weighted_sum``, ``signplane_weighted_aggregate`` and the
  three planes' aggregates: within ``4 * G * eps32 * sum_g w_g *
  ||x_g||_inf``;
* ``Quantizer.batched``: each row bit for bit ``__call__`` on that row
  and JAX's batched recon, bits, dbar and dw_q;
* the whole slice against the JAX engine: the packed plane's trajectory
  tolerances (``tests/_torch_parity.py``).
"""
import dataclasses

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
from repro.dist import compressor as jcomp
from repro.fl.loop import FLConfig as JFL
from repro.fl.loop import local_adagrad as jlocal_adagrad
from repro.kernels import WirePath as JWire
from repro.kernels import ops as jops
from repro.kernels import quant_pack as jqp
from repro.kernels import ref as jref
from repro.sim import EngineConfig as JEngineConfig
from repro.sim import VectorizedFLEngine as JEngine
from repro_torch import dist as tdist
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.core.power import BisectionLPPowerControl
from repro_torch.core.quantize import MixedResolutionQuantizer, Quantizer
from repro_torch.core.quantize.base import QuantResult
from repro_torch.data import make_image_classification, partition_dirichlet
from repro_torch.dist import compressor as tcomp
from repro_torch.fl.cnn import params_from_jax
from repro_torch.fl.loop import FLConfig
from repro_torch.kernels import LAUNCHES, WirePath
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_pack as tqp
from repro_torch.kernels import ref as tref
from repro_torch.sim import EngineConfig, VectorizedFLEngine

EPS32 = float(np.finfo(np.float32).eps)
# rows of 128 lanes a plane: 29 (the narrow CNN), 512, and 775, which
# sign_pad_len pads to 1024
ROWS = [29, 512, 775]
# d = 3610 (W = 29, masked), 65500 (W = 512, d % 128 != 0) and 128*257
# (W = 257, padded to 512)
DIMS = [3610, 65500, 128 * 257]


def deltas(seed, G, d):
    """Heavy-tailed f32 deltas with an all-zero user 1 (when G > 1) and
    no subnormals."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, d)).astype(np.float32)
    x[:, rng.choice(d, size=max(1, d // 64), replace=False)] *= 50.0
    x[np.abs(x) < np.finfo(np.float32).tiny] = 0.0
    if G > 1:
        x[1] = 0.0
    return x


def sign_rows(seed, G, rows):
    """[G * rows_padded, 128] f32 rows holding zeros, -0.0, NaN, +-inf,
    an all-negative and an all-positive row, no subnormals."""
    x = deltas(seed, G, rows * 128)
    rng = np.random.default_rng(seed + 1)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, size=6 * G, replace=False)
    flat[idx[0::6]] = 0.0
    flat[idx[1::6]] = -0.0
    flat[idx[2::6]] = np.nan
    flat[idx[3::6]] = -np.nan
    flat[idx[4::6]] = np.inf
    flat[idx[5::6]] = -np.inf
    x[0, :128] = -np.abs(x[0, :128]) - 1.0        # all negative
    x[-1, -128:] = np.abs(x[-1, -128:]) + 1.0     # all positive
    padded = np.asarray(jops.wire_view(jnp.asarray(x)))
    return padded.reshape(-1, 128)


def block_rows(rows_padded):
    """The JAX package's block for G stacked planes of this height."""
    return rows_padded if rows_padded <= 256 else 256


def agg_tol(w, x):
    """4 * G * eps32 * sum_g w_g * ||x_g||_inf."""
    w = np.abs(np.asarray(w, np.float64))
    inf = np.abs(np.asarray(x, np.float64)).max(axis=1)
    return 4 * len(w) * EPS32 * float(np.sum(w * inf))


def weights(seed, G):
    return np.random.default_rng(seed).uniform(0.05, 0.4, G).astype(
        np.float32)


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("G", [1, 3, 8])
def test_k4_signpack_plain_matches_jax(rows, G):
    x = sign_rows(rows + G, G, rows)
    rp = x.shape[0] // G
    want = np.asarray(jqp.signpack(jnp.asarray(x), interpret=True,
                                   block_rows=block_rows(rp)))
    oracle = np.asarray(jref.signpack_ref(jnp.asarray(x)))
    np.testing.assert_array_equal(want, oracle)
    plain = tref.signpack_ref(torch.tensor(x))
    wrapped = tqp.signpack(torch.tensor(x))
    assert plain.dtype == wrapped.dtype == torch.uint32
    assert plain.shape == (G * rp, 4)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(wrapped.numpy(), want)


def test_k4_signpack_op_matches_jax():
    x = sign_rows(11, 1, 512).reshape(-1)
    want = np.asarray(jops.signpack_op(jnp.asarray(x)))
    got = tops.signpack_op(torch.tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_positive_subnormal_keeps_its_sign_bit():
    """x > 0 is IEEE in the port: the smallest positive subnormal packs
    as bit 1, on the CPU as on the card (no ftz in the CUDA build).  XLA
    on the CPU flushes subnormals to zero and packs bit 0 — the one
    known divergence from the JAX package, which the port does not
    mimic."""
    x = np.zeros((1, 128), np.float32)
    x[0, 37] = np.float32(1.4e-45)
    x[0, 70] = -np.float32(1.4e-45)
    words = tref.signpack_ref(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(words, [[0, 1 << 5, 0, 0]])
    jwords = np.asarray(jref.signpack_ref(jnp.asarray(x)))
    np.testing.assert_array_equal(jwords, [[0, 0, 0, 0]])


# ------------------------------------------------------------------ K5
@pytest.mark.parametrize("rows", [29, 512, 1024])
@pytest.mark.parametrize("G", [1, 3, 8])
def test_k5_sign_dequant_reduce_plain_matches_jax(rows, G):
    rng = np.random.default_rng(rows * 10 + G)
    words = rng.integers(0, 2 ** 32, size=(G, rows, 4), dtype=np.uint32)
    words[0, 0] = 0                                  # all bits clear
    words[-1, -1] = 0xFFFFFFFF                       # all bits set
    scales = rng.uniform(-1.0, 3.0, G).astype(np.float32)
    want = np.asarray(jqp.sign_dequant_reduce(
        jnp.asarray(words), jnp.asarray(scales), interpret=True,
        block_rows=block_rows(rows)))
    got = tqp.sign_dequant_reduce(torch.tensor(words), torch.tensor(scales))
    plain = tref.sign_dequant_reduce_ref(torch.tensor(words),
                                         torch.tensor(scales))
    assert torch.equal(got, plain)
    tol = G * EPS32 * float(np.sum(np.abs(scales.astype(np.float64))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_k5_folds_peers_left_to_right():
    """The plain version is ((u_0 + u_1) + u_2), not another order."""
    words = np.array([[[0xFFFFFFFF] * 4]] * 3, np.uint32)
    scales = np.array([1.0, 2.0 ** -24, 2.0 ** -24], np.float32)
    out = tref.sign_dequant_reduce_ref(torch.tensor(words),
                                       torch.tensor(scales))
    # 1 + 2^-24 rounds back to 1 (half to even), twice
    assert torch.all(out == 1.0)
    words[0] = 0                                   # -1 + 2^-24 + 2^-24
    out = tref.sign_dequant_reduce_ref(torch.tensor(words),
                                       torch.tensor(scales))
    assert torch.all(out == np.float32(-1.0 + 2.0 ** -23))


def test_k5_sign_dequant_reduce_op_matches_jax():
    rng = np.random.default_rng(12)
    words = rng.integers(0, 2 ** 32, size=(3, 512 * 4), dtype=np.uint32)
    scales = rng.uniform(0.1, 1.0, 3).astype(np.float32)
    want = np.asarray(jops.sign_dequant_reduce_op(jnp.asarray(words),
                                                  jnp.asarray(scales)))
    got = tops.sign_dequant_reduce_op(torch.tensor(words),
                                      torch.tensor(scales))
    tol = 3 * EPS32 * float(np.sum(scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# -------------------------------------------------- sign-plane wire path
@pytest.mark.parametrize("d", DIMS)
def test_packed_sign_weighted_sum_matches_jax(d):
    G = 5
    x = deltas(d, G, d)
    w = weights(d, G)
    dw_q = np.asarray(JMixed(0.2, 10).batched(jnp.asarray(x))[0]
                      .aux["dw_q"])
    scales = (w * dw_q * np.float32(0.5)).astype(np.float32)
    want = np.asarray(jops.packed_sign_weighted_sum(jnp.asarray(x),
                                                    jnp.asarray(scales)))
    got = tops.packed_sign_weighted_sum(torch.tensor(x),
                                        torch.tensor(scales))
    assert got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=agg_tol(w, x))


@pytest.mark.parametrize("d", DIMS)
def test_signplane_weighted_aggregate_matches_jax(d):
    G = 5
    x = deltas(d + 1, G, d)
    w = weights(d + 1, G)
    jres, _ = JMixed(0.2, 10).batched(jnp.asarray(x))
    want = np.asarray(jcomp.signplane_weighted_aggregate(
        jnp.asarray(x), jres.recon, jres.aux["dw_q"], jnp.asarray(w)))
    tres, _ = MixedResolutionQuantizer(0.2, 10).batched(torch.tensor(x))
    got = tdist.signplane_weighted_aggregate(
        torch.tensor(x), tres.recon, tres.aux["dw_q"], torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=agg_tol(w, x))


def test_lo_plane_and_sign_scales_match_jax():
    x = deltas(21, 3, 600)
    x[0, :5] = [0.0, -0.0, 1.0, -1.0, np.nan]
    dw_q = np.array([0.5, 0.0, 2.25], np.float32)
    np.testing.assert_array_equal(
        tcomp.lo_plane(torch.tensor(x), torch.tensor(dw_q)).numpy(),
        np.asarray(jcomp.lo_plane(jnp.asarray(x), jnp.asarray(dw_q))))
    np.testing.assert_array_equal(
        tcomp._sign_scales(torch.tensor(dw_q), 3).numpy(),
        np.asarray(jcomp._sign_scales(jnp.asarray(dw_q), 3)))


# ------------------------------------------------------ Quantizer.batched
@pytest.mark.parametrize("d", [3610, 65500])
@pytest.mark.parametrize("lam,b", [(0.2, 10), (0.0, 4), (1.0, 16),
                                   (0.05, 20)])
def test_batched_rows_are_call_bit_for_bit(d, lam, b):
    x = deltas(d + b, 4, d)
    x[3] = -0.75                                   # step == 0 grid
    q = MixedResolutionQuantizer(lam, b)
    res, state = q.batched(torch.tensor(x))
    assert state is None and res.recon.shape == (4, d)
    for k in range(4):
        one, _ = q(torch.tensor(x[k]))
        assert torch.equal(res.recon[k].view(torch.int32),
                           one.recon.view(torch.int32))
        assert torch.equal(res.bits[k], one.bits)
        for key in ("s", "dbar", "dw_q", "inf", "r"):
            assert torch.equal(res.aux[key][k], one.aux[key]), key
    jres, _ = JMixed(lam, b).batched(jnp.asarray(x))
    np.testing.assert_array_equal(res.recon.numpy(), np.asarray(jres.recon))
    np.testing.assert_array_equal(res.bits.numpy(), np.asarray(jres.bits))
    for key in ("dbar", "dw_q"):
        np.testing.assert_array_equal(res.aux[key].numpy(),
                                      np.asarray(jres.aux[key]))


class _Stateful(Quantizer):
    """A stub stateful quantizer: recon = delta + state, state += 1."""
    name = "stub"

    def init_state(self, dim):
        return torch.zeros(dim)

    def __call__(self, delta, state=None):
        return QuantResult(recon=delta + state, bits=delta.sum() * 0 + 7.0,
                           aux={}), state + 1.0


def test_batched_threads_stacked_state():
    q = _Stateful()
    states = q.init_batched_state(3, 5)
    assert states.shape == (3, 5)
    x = torch.arange(15.0).reshape(3, 5)
    res, new = q.batched(x, states)
    assert torch.equal(res.recon, x) and torch.equal(new, states + 1.0)
    assert res.bits.shape == (3,)
    assert MixedResolutionQuantizer().init_batched_state(3, 5) is None


# ---------------------------------------------- three planes, one identity
@pytest.mark.parametrize("d", DIMS)
def test_three_planes_agree(d):
    """signplane == dense == packed on the same deltas, within the
    aggregation bound (lambda > 0, so no high-resolution element is 0)."""
    K, lam, b = 5, 0.2, 10
    x = torch.tensor(deltas(d + 2, K, d))
    w = torch.tensor(weights(d + 2, K))
    q = MixedResolutionQuantizer(lam, b)
    res, _ = q.batched(x)
    dense = torch.einsum("k,kd->d", w, res.recon)
    sign = tdist.signplane_weighted_aggregate(x, res.recon,
                                              res.aux["dw_q"], w)
    packed, bits, aux = tops.mixed_res_wire_aggregate(x, w, lam, b)
    tol = agg_tol(w.numpy(), x.numpy())
    np.testing.assert_allclose(sign.numpy(), dense.numpy(), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(packed.numpy(), dense.numpy(), rtol=0,
                               atol=tol)
    assert torch.equal(bits, res.bits)
    assert torch.equal(aux["dbar"].to(torch.int64), res.aux["dbar"])


# --------------------------------------------- whole slice vs the JAX engine
NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)
K, T, L, BATCH, N_TRAIN, N_TEST, LAM, B = 4, 3, 2, 8, 160, 40, 0.2, 10


@pytest.fixture(scope="module", params=["signplane", "dense"])
def both_runs(request):
    """T rounds of both engines on one plane from one init, data,
    channel and minibatch stream."""
    plane = request.param
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
                   engine=JEngineConfig(fused=True, wire=JWire(plane=plane)))
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
        FLConfig(**fl), engine=EngineConfig(fused=True,
                                            wire=WirePath(plane=plane)),
        device="cpu", init_params=init)
    before = dict(LAUNCHES)
    tres = teng.run()
    assert LAUNCHES == before                # CPU tensors: plain versions
    return plane, jeng, jres, teng, tres, jtrain, jshards


def dbar_of(bits, d):
    return np.rint((np.asarray(bits, np.float64) - d - 32.0) / (B - 1))


def bits_formula(dbar, d):
    s = np.float32(dbar) / np.float32(d)
    bits = np.float32(d) * (np.float32(B) * s + np.float32(1.0) - s) \
        + np.float32(32.0)
    return bits.astype(np.float64)


def test_round_logs_match_jax_engine(both_runs):
    _, jeng, jres, teng, tres, _, _ = both_runs
    d = teng.d
    assert d == jeng.d == 3610
    assert len(tres.logs) == len(jres.logs) == T
    for jl, tl in zip(jres.logs, tres.logs):
        jd, td = dbar_of(jl.bits_per_user, d), dbar_of(tl.bits_per_user, d)
        assert np.all(np.abs(jd - td) <= 2), (jd, td)
        np.testing.assert_array_equal(tl.bits_per_user,
                                      bits_formula(td, d))
        np.testing.assert_allclose(tl.cum_latency_s, jl.cum_latency_s,
                                   rtol=1e-3)
        assert abs(tl.test_acc - jl.test_acc) * N_TEST <= 2 + 1e-9
        np.testing.assert_allclose(tl.mean_s, jl.mean_s, rtol=0,
                                   atol=2.0 / d)


def test_params_match_jax_engine(both_runs):
    _, jeng, jres, _, tres, _, _ = both_runs
    flips = int(sum(np.abs(dbar_of(jl.bits_per_user, jeng.d)
                           - dbar_of(tl.bits_per_user, jeng.d)).sum()
                    for jl, tl in zip(jres.logs, tres.logs)))
    assert_trajectory_close(
        {k: v.numpy() for k, v in tres.params.items()},
        {k: np.asarray(v) for k, v in jres.params.items()},
        flips, rounds=T, L=L, alpha=0.01)


def test_jax_round1_deltas_through_port_aggregate(both_runs):
    """JAX's own round-1 deltas through the port's plane: bits, dbar and
    dw_q exact, the aggregate within the bound of the JAX engine's
    (``_signplane_aggregate`` or the dense einsum)."""
    plane, jeng, _, teng, _, jtrain, jshards = both_runs
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
    jres, _ = JMixed(LAM, B).batched(jnp.asarray(flat))
    if plane == "signplane":
        want = jcomp.signplane_weighted_aggregate(
            jnp.asarray(flat), jres.recon, jres.aux["dw_q"], jnp.asarray(w))
    else:
        want = jnp.einsum("k,kd->d", jnp.asarray(w), jres.recon)
    agg, bits, aux, _ = teng.aggregate(torch.tensor(flat))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jres.bits))
    for key in ("dbar", "dw_q"):
        np.testing.assert_array_equal(aux[key].numpy(),
                                      np.asarray(jres.aux[key]))
    np.testing.assert_allclose(agg.numpy(), np.asarray(want), rtol=0,
                               atol=agg_tol(w, flat))


# ---------------------------------------------------- constructor rules
def _tiny_problem():
    from repro_torch.sim import get_scenario
    from repro_torch.sim.scenarios import build_problem
    scn = dataclasses.replace(get_scenario("paper-table3"), K=4, T=1,
                              n_train=160, n_test=40, batch_size=8, L=1,
                              M=None)
    return build_problem(scn)[:4]


class _NotMixed(Quantizer):
    name = "stub"

    def __call__(self, delta, state=None):
        return QuantResult(recon=delta, bits=delta.sum() * 0 + 32.0,
                           aux={}), state


def test_signplane_rejects_non_mixed_quantizer():
    fl = FLConfig(L=1, T=1, batch_size=8, seed=0)
    with pytest.raises(ValueError, match="signplane"):
        VectorizedFLEngine(*_tiny_problem(), _NotMixed(), None, None, fl,
                           engine=EngineConfig(
                               wire=WirePath(plane="signplane")),
                           device="cpu")
    # the dense plane takes any quantizer and averages its recons
    eng = VectorizedFLEngine(*_tiny_problem(), _NotMixed(), None, None, fl,
                             engine=EngineConfig(
                                 fused=True, wire=WirePath(plane="dense")),
                             device="cpu")
    flat = torch.randn(4, eng.d)
    agg, bits, _, _ = eng.aggregate(flat)
    torch.testing.assert_close(agg, eng._weights @ flat, rtol=0, atol=1e-6)
    assert eng.run().rounds_completed == 1


@pytest.mark.parametrize("plane,ok", [("dense", True), ("signplane", True),
                                      ("packed", False)])
def test_wide_codes_only_limit_the_packed_plane(plane, ok):
    fl = FLConfig(L=1, T=1, batch_size=8, seed=0)
    make = lambda: VectorizedFLEngine(
        *_tiny_problem(), MixedResolutionQuantizer(0.2, 20), None, None,
        fl, engine=EngineConfig(fused=True, wire=WirePath(plane=plane)),
        device="cpu")
    if not ok:
        with pytest.raises(ValueError, match="16 bits"):
            make()
        return
    eng = make()
    bits = eng.run().logs[0].bits_per_user
    assert np.all((bits > eng.d + 32) & (bits <= 20 * eng.d + 32)), bits

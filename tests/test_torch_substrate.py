"""Parity of the port's host and model layers with the JAX package:
data, partitions, channel and power control (numpy copies — exactly
equal at the same seed), the flatten order, the golden quantizer, and
the paper CNN's forward, loss, gradients and local AdaGrad run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import PaperCNNConfig as JCfg
from repro.core.channel import CFmMIMOConfig as JChanCfg
from repro.core.channel import make_channel as jmake_channel
from repro.core.power import BisectionLPPowerControl as JBisection
from repro.core.quantize.base import flatten_pytree as jflatten
from repro.data import federated as jfed
from repro.data import synthetic as jsyn
from repro.fl import cnn as jcnn
from repro.fl.loop import local_adagrad as jlocal_adagrad
from repro_torch.configs.paper_cnn import PaperCNNConfig
from repro_torch.core.channel import CFmMIMOConfig, make_channel
from repro_torch.core.power import (BisectionLPPowerControl,
                                    make_power_controller)
from repro_torch.core.quantize import (flatten_pytree, make_quantizer,
                                       unflatten_pytree)
from repro_torch.data import federated as tfed
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import cnn as tcnn
from repro_torch.fl.loop import local_adagrad

NARROW = dict(input_hw=12, conv_filters=8, dense_units=16)


# ------------------------------------------------- numpy host layers
def test_synthetic_data_is_identical():
    a = jsyn.make_image_classification(64, hw=12, seed=3)
    b = tsyn.make_image_classification(64, hw=12, seed=3)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.n_classes == b.n_classes


@pytest.mark.parametrize("kind", ["iid", "dirichlet", "powerlaw"])
def test_partitions_are_identical(kind):
    ds_j = jsyn.make_image_classification(300, hw=8, seed=1)
    ds_t = tsyn.make_image_classification(300, hw=8, seed=1)
    fn = lambda m: getattr(m, f"partition_{kind}")
    a, b = fn(jfed)(ds_j, 7, seed=2), fn(tfed)(ds_t, 7, seed=2)
    assert len(a) == len(b) == 7
    for s, t in zip(a, b):
        np.testing.assert_array_equal(s, t)
    np.testing.assert_array_equal(jfed.user_fractions(a),
                                  tfed.user_fractions(b))
    with pytest.raises(ValueError, match="empty"):
        tfed.validate_shards([np.arange(3), np.array([], np.int64)])


def test_channel_and_power_are_identical():
    jc = jmake_channel(JChanCfg(M=16, N=4, K=12), seed=5)
    tc = make_channel(CFmMIMOConfig(M=16, N=4, K=12), seed=5)
    for f in ("beta", "pilot", "gamma", "A_bar", "B_bar", "B_tilde", "I_M"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    bits = np.random.default_rng(5).uniform(1e5, 5e5, 12)
    js, ts = JBisection().solve(jc, bits), BisectionLPPowerControl().solve(
        tc, bits)
    np.testing.assert_array_equal(js.p, ts.p)
    np.testing.assert_array_equal(js.latencies, ts.latencies)
    assert js.info == ts.info
    assert isinstance(make_power_controller("bisection-lp"),
                      BisectionLPPowerControl)
    with pytest.raises(KeyError, match="bisection-lp"):
        make_power_controller("water-filling")


# ------------------------------------------------------------- model
def jax_init(cfg=NARROW, seed=0):
    return {k: np.asarray(v) for k, v in
            jcnn.init_cnn(jax.random.PRNGKey(seed), JCfg(**cfg)).items()}


def test_flatten_order_and_carry_match_jax():
    """The port's params are the JAX layout; the flat vector is
    flatten_pytree's, d = 3610 for the narrow CNN, 462410 for CIFAR10."""
    npp = jax_init()
    tp = tcnn.params_from_jax(npp)
    flat, spec = flatten_pytree(tp)
    jflat, _ = jflatten({k: jnp.asarray(v) for k, v in npp.items()})
    assert flat.numel() == 3610
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = unflatten_pytree(flat, spec)
    assert list(back) == sorted(tp)
    for k in tp:
        assert torch.equal(back[k], tp[k])
    for k, v in tcnn.params_to_jax(tp).items():
        np.testing.assert_array_equal(v, npp[k])
    full = tcnn.init_cnn(torch.Generator().manual_seed(0), PaperCNNConfig())
    assert flatten_pytree(full)[0].numel() == 462410
    for k, v in jax_init(cfg={}).items():
        assert tuple(full[k].shape) == v.shape


def batch(seed=0, n=8, hw=12):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int64))


def test_cnn_forward_loss_grads_match_jax():
    npp = jax_init()
    x, y = batch()
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tp = tcnn.params_from_jax(npp)
    tx, ty = torch.tensor(x), torch.tensor(y)
    np.testing.assert_allclose(
        tcnn.cnn_forward(tp, tx).detach().numpy(),
        np.asarray(jcnn.cnn_forward(jp, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    jl, jg = jax.value_and_grad(jcnn.cnn_loss)(jp, jnp.asarray(x),
                                               jnp.asarray(y))
    tl = tcnn.cnn_loss(tp, tx, ty)
    tg = torch.func.grad(tcnn.cnn_loss)(tp, tx, ty)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    for k in npp:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)
    assert tcnn.cnn_accuracy(tp, tx, ty) == jcnn.cnn_accuracy(
        jp, jnp.asarray(x), jnp.asarray(y))


def test_local_adagrad_matches_jax():
    """L = 2 AdaGrad steps on the engine's synthetic data agree to
    1e-4 of the largest delta element.  The gradients agree to f32
    roundoff (the test above), but AdaGrad's ``1 / sqrt(G + 1e-8)``
    magnifies the roundoff of a near-zero gradient element by up to
    ``alpha / sqrt(1e-8)``: measured 3.6e-5 of max|delta| at this
    seed, so 1e-5 of max|delta| is out of reach for any two conv
    libraries that sum in different orders."""
    npp = jax_init()
    L, alpha = 2, 0.01
    ds = jsyn.make_image_classification(200, hw=12, seed=0)
    rng = np.random.default_rng(0)
    sel = np.stack([rng.choice(200, 8, replace=False) for _ in range(L)])
    xs, ys = ds.x[sel], ds.y[sel]
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    jw = jlocal_adagrad(jp, jnp.asarray(xs), jnp.asarray(ys), L, alpha)
    tp = tcnn.params_from_jax(npp)
    tw = local_adagrad(tp, torch.tensor(xs), torch.tensor(ys), L, alpha)
    jd = np.asarray(jflatten({k: jw[k] - jp[k] for k in jp})[0])
    td = flatten_pytree({k: tw[k] - tp[k] for k in tp})[0].numpy()
    np.testing.assert_allclose(td, jd, rtol=0,
                               atol=1e-4 * np.max(np.abs(jd)))


def test_port_init_is_seeded_and_scaled():
    cfg = PaperCNNConfig(**NARROW)
    a = tcnn.init_cnn(torch.Generator().manual_seed(1), cfg)
    b = tcnn.init_cnn(torch.Generator().manual_seed(1), cfg)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert torch.count_nonzero(a["conv_b"]) == 0
    assert abs(float(a["dense1_w"].std()) * np.sqrt(cfg.flat_dim) - 1) < 0.1


def test_quantizer_registry():
    from repro.core.quantize import lemma1_bound as jbound
    q = make_quantizer("mixed-resolution", lambda_=0.3, b=6)
    assert (q.name, q.lambda_, q.b) == ("mixed-resolution", 0.3, 6)
    assert q.error_bound() == jbound(0.3, 6)
    with pytest.raises(KeyError, match="mixed-resolution"):
        make_quantizer("qsgd")
    with pytest.raises(ValueError):
        make_quantizer("mixed-resolution", lambda_=1.5)

"""The port's baseline quantizers (classic FL, top-q, LAQ, AQUILA)
against the JAX package's, on the CPU, at small d, on numpy inputs
from a seed.  None of these reaches a Pallas kernel: JAX runs its jnp
path, the port plain PyTorch.

Contract and tolerances:

* classic and top-q: ``recon``, ``bits`` and ``aux`` bit for bit, top-q
  also with ties planted at its threshold (every tied element is kept,
  whatever order ``torch.topk`` returns them in);
* AQUILA: each candidate reconstruction is elementwise given
  ``max|x|``, so ``recon`` and ``bits`` are bit for bit wherever the two
  packages select the same ``b``.  ``rel_err`` is a norm whose value
  depends on the reduction's order (within 1e-6 relative).  **Tie
  rule:** ``b_selected`` is the same unless a candidate's error lies
  within 1e-6 of ``tol``; there each package may accept or refuse that
  candidate, and the port selects the smallest ``b`` whose own error is
  at most ``tol`` (rounded to f32);
* LAQ over 5 successive calls, each package threading its own state:
  ``recon``, ``bits`` and the state's ``last_sent`` and ``ptr`` bit for
  bit, ``energies`` within 1e-6 relative.  A skip decision may differ
  only where ``|energy - xi * hist| <= 1e-5 * hist`` (the energy is a
  sum whose order differs);
* ``Quantizer.batched`` equals ``__call__`` row by row, bit for bit, and
  ``init_batched_state`` gives every user storage of its own.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro_torch.core import quantize as tq
from repro_torch.core.quantize.laq import _uniform_quantize

STATELESS = [("classic", {}), ("top-q", {"q": 0.01}), ("top-q", {"q": 0.3}),
             ("aquila", {"b_min": 2, "b_max": 8, "tol": 0.05}),
             ("aquila", {"b_min": 3, "b_max": 5, "tol": 0.01})]


def deltas(seed, K, d):
    """Heavy-tailed f32 deltas with an all-zero user 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, d)).astype(np.float32)
    x[:, rng.choice(d, size=max(1, d // 64), replace=False)] *= 30.0
    x[1] = 0.0
    return x


def np_of(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def assert_same(a, b):
    a, b = np_of(a), np_of(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_registry_holds_the_jax_names():
    assert list(tq.QUANTIZERS) == list(jq.QUANTIZERS)
    for name in tq.QUANTIZERS:
        assert tq.make_quantizer(name).name == jq.make_quantizer(name).name
    with pytest.raises(KeyError, match="top-q"):
        tq.make_quantizer("qsgd")
    for name, kw in (("top-q", {"q": 0.0}), ("aquila", {"b_min": 1}),
                     ("aquila", {"b_min": 5, "b_max": 4})):
        with pytest.raises(ValueError):
            tq.make_quantizer(name, **kw)


@pytest.mark.parametrize("d", [3001, 4096])
@pytest.mark.parametrize("name,kw", STATELESS)
def test_stateless_quantizers_match_jax(name, kw, d):
    x = deltas(d, 5, d)
    jres, _ = jq.make_quantizer(name, **kw).batched(jnp.asarray(x))
    tres, state = tq.make_quantizer(name, **kw).batched(torch.tensor(x))
    assert state is None
    assert_same(tres.recon, jres.recon)
    assert_same(tres.bits, jres.bits)
    assert sorted(tres.aux) == sorted(jres.aux)
    for key in tres.aux:
        if key == "rel_err":
            np.testing.assert_allclose(np_of(tres.aux[key]),
                                       np_of(jres.aux[key]), rtol=1e-6)
        else:
            assert_same(tres.aux[key], jres.aux[key])
    if name == "aquila":
        # no candidate sits within 1e-6 of tol here, so b must agree
        assert min_gap_to_tol(x, kw) > 1e-6


def candidate_errors(x, b_min, b_max):
    """Each candidate's relative l2 error in f64, from the port's
    (bit-exact) candidate reconstructions: [K, n_candidates]."""
    xs = torch.tensor(x)
    out = []
    for row in xs:
        norm = float(np.linalg.norm(row.double().numpy())) or 1.0
        out.append([float(np.linalg.norm(
            (_uniform_quantize(row, b) - row).double().numpy())) / norm
            for b in range(b_min, b_max + 1)])
    return np.array(out)


def min_gap_to_tol(x, kw):
    errs = candidate_errors(x, kw.get("b_min", 2), kw.get("b_max", 8))
    return float(np.abs(errs - np.float32(kw.get("tol", 0.05))).min())


def test_aquila_on_the_tolerance():
    """``tol`` set to JAX's own f32 error of b = 4 on user 0, so that
    candidate sits on the tolerance.  The port obeys the tie rule."""
    x = deltas(11, 4, 2048)
    x[1] = np.random.default_rng(12).standard_normal(2048)
    b_min, b_max = 2, 8
    jerr = float(np.asarray(jq.aquila_quantize(
        jnp.asarray(x[0]), 4, 4, 0.0).aux["rel_err"]))
    kw = dict(b_min=b_min, b_max=b_max, tol=jerr)
    jres, _ = jq.make_quantizer("aquila", **kw).batched(jnp.asarray(x))
    tres, _ = tq.make_quantizer("aquila", **kw).batched(torch.tensor(x))
    jb, tb = np_of(jres.aux["b_selected"]), np_of(tres.aux["b_selected"])
    assert jb[0] == 4                        # JAX accepts b = 4 exactly
    errs = candidate_errors(x, b_min, b_max)
    tol32 = np.float32(jerr)
    for k in range(len(x)):
        xs = torch.tensor(x[k])
        cands = [_uniform_quantize(xs, b) for b in range(b_min, b_max + 1)]
        own = [float(torch.linalg.vector_norm(c - xs)
                     / torch.linalg.vector_norm(xs)) for c in cands]
        ok = [i for i, e in enumerate(own) if np.float32(e) <= tol32]
        want = b_min + (ok[0] if ok else len(cands) - 1)
        assert tb[k] == want, (k, tb[k], want)
        assert_same(tres.recon[k], cands[tb[k] - b_min])
        assert float(tres.bits[k]) == 2048.0 * tb[k] + 32.0
        if tb[k] != jb[k]:
            first = min(tb[k], jb[k]) - b_min
            assert abs(errs[k, first] - tol32) <= 1e-6, (k, errs[k])
        else:
            assert_same(tres.recon[k], jres.recon[k])
            assert_same(tres.bits[k], jres.bits[k])


def test_topq_keeps_every_tied_element():
    d, q = 1000, 0.01                        # k = 10
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, d)) * 0.01).astype(np.float32)
    x[0, :5] = [1.0, -2.0, 3.0, -4.0, 5.0]
    tied = rng.choice(np.arange(5, d), size=20, replace=False)
    x[0, tied] = np.where(rng.random(20) < 0.5, 0.5, -0.5)  # the 10th value
    x[1, rng.choice(d, size=40, replace=False)] = -0.25      # all tied
    x[2, :] = 0.0
    jres, _ = jq.make_quantizer("top-q", q=q).batched(jnp.asarray(x))
    tres, _ = tq.make_quantizer("top-q", q=q).batched(torch.tensor(x))
    assert int(np.count_nonzero(np_of(tres.recon[0]))) == 25
    assert int(np.count_nonzero(np_of(tres.recon[1]))) == 40
    assert_same(tres.recon, jres.recon)
    assert_same(tres.bits, jres.bits)
    assert_same(tres.aux["k"], jres.aux["k"])
    assert_same(tres.aux["s"], jres.aux["s"])


def laq_inputs(seed, K, d, calls):
    """Per call [K, d] deltas that drift at a different rate per user,
    so some users' innovations fall below the lazy threshold."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((K, d)).astype(np.float32)
    drift = np.array([0.0, 0.02, 0.05, 0.1, 0.4, 1.0][:K], np.float32)
    for _ in range(calls):
        yield base
        base = base + drift[:, None] * rng.standard_normal(
            (K, d)).astype(np.float32)


def test_laq_over_five_calls_matches_jax():
    K, d, kw = 6, 3000, dict(b=4, xi=0.5, history=4)
    jquant, tquant = jq.make_quantizer("laq", **kw), \
        tq.make_quantizer("laq", **kw)
    js = jquant.init_batched_state(K, d)
    ts = tquant.init_batched_state(K, d)
    live = np.ones(K, bool)                 # users not yet diverged
    skips = 0
    for x in laq_inputs(7, K, d, 5):
        hist = np_of(js.energies).astype(np.float64).mean(axis=1)
        jres, js = jquant.batched(jnp.asarray(x), js)
        tres, ts = tquant.batched(torch.tensor(x), ts)
        jskip, tskip = np_of(jres.aux["skipped"]), np_of(tres.aux["skipped"])
        energy = np_of(jres.aux["energy"]).astype(np.float64)
        for k in np.flatnonzero(live & (jskip != tskip)):
            assert abs(energy[k] - 0.5 * hist[k]) <= 1e-5 * hist[k], k
            live[k] = False
        skips += int(jskip[live].sum())
        for k in np.flatnonzero(live):
            assert_same(tres.recon[k], jres.recon[k])
            assert_same(tres.bits[k], jres.bits[k])
            assert_same(ts.last_sent[k], js.last_sent[k])
            assert_same(ts.ptr[k], js.ptr[k])
            np.testing.assert_allclose(np_of(ts.energies[k]),
                                       np_of(js.energies[k]), rtol=1e-6)
            np.testing.assert_allclose(np_of(tres.aux["energy"][k]),
                                       energy[k], rtol=1e-6)
    assert live.all()
    assert 0 < skips < 4 * K                 # both branches exercised


@pytest.mark.parametrize("name,kw", STATELESS[:4] + [
    ("laq", {"b": 4, "xi": 0.5}), ("mixed-resolution", {"lambda_": 0.4,
                                                          "b": 4})])
def test_batched_equals_per_row_call(name, kw):
    x = torch.tensor(deltas(21, 4, 2500))
    q = tq.make_quantizer(name, **kw)
    states = q.init_batched_state(4, 2500)
    for _ in range(2):
        res, new = q.batched(x, states)
        for k in range(4):
            one = None if states is None else type(states)(
                *(s[k] for s in states))
            r, s = q(x[k], one)
            assert_same(res.recon[k], r.recon)
            assert_same(res.bits[k], r.bits)
            for key in r.aux:
                assert_same(res.aux[key][k], r.aux[key])
            if s is not None:
                for a, b in zip(new, s):
                    assert_same(a[k], b)
        states, x = new, x * 0.9


def test_batched_state_rows_are_independent_storage():
    q = tq.make_quantizer("laq", b=4, xi=0.5, history=3)
    states = q.init_batched_state(3, 7)
    for leaf in states:
        assert leaf.shape[0] == 3 and leaf.stride(0) != 0
        ptrs = {leaf[k].data_ptr() for k in range(3)}
        assert len(ptrs) == 3
    states.last_sent[0].add_(1.0)
    states.energies[0].fill_(2.0)
    states.ptr[0] += 1
    assert float(states.last_sent[1:].abs().sum()) == 0.0
    assert float(states.energies[1:].abs().sum()) == 0.0
    assert states.ptr[1:].tolist() == [0, 0]
    fresh = q.init_batched_state(3, 7)
    assert float(fresh.last_sent.abs().sum()) == 0.0
    assert tq.make_quantizer("top-q").init_batched_state(3, 7) is None

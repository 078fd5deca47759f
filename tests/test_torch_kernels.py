"""Parity of the port's wire kernels K1–K3 and the packed wire path
(``repro_torch.kernels``) with the JAX package's Pallas kernels, run in
interpret mode, and their jnp oracles — on the CPU, where the port's
wrappers run the plain PyTorch versions the CUDA kernels are held to.

Contract (DESIGN.md §9, as ``tests/test_quant_kernels.py`` pins it for
the JAX package): packed planes, header lanes 0-4, ``bits``, ``dbar``
and ``s`` bit-exact; the weighted reduce within
``2 * G * eps32 * sum_g w_g * inf_g`` of the JAX kernel elementwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize.mixed_resolution import \
    mixed_resolution_quantize as jax_quantize
from repro.kernels import mixed_res as jmr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.quantize import mixed_resolution_quantize
from repro_torch.kernels import LAUNCHES, WirePath, mixed_res as tmr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

EPS32 = float(np.finfo(np.float32).eps)
# W = 29 rows (d = 3610, the narrow CNN; masked) and W = 512 rows with
# d % 128 != 0
DIMS = [3610, 65500]


def deltas(seed, U, d):
    """Heavy-tailed f32 deltas with an all-zero user 1 and no
    subnormals (XLA on the CPU flushes them, torch does not)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((U, d)).astype(np.float32)
    x[:, rng.choice(d, size=max(1, d // 64), replace=False)] *= 50.0
    x[np.abs(x) < np.finfo(np.float32).tiny] = 0.0
    x[1] = 0.0
    return x


def planes_np(t):
    return [a.numpy() for a in t]


def reduce_tol(w, head):
    """2 * G * eps32 * sum_g w_g * inf_g (DESIGN.md §9's 2 ulp of
    ||x||_inf at G = 1, grown with the number of users summed)."""
    w = np.asarray(w, np.float64)
    return 2 * len(w) * EPS32 * float(np.sum(np.abs(w) * head[:, 0]))


def encode_both(x, lam, b):
    jw = jops.mixed_res_encode(jnp.asarray(x), lam, b, use_kernel=False)
    tw = tops.mixed_res_encode(torch.tensor(x), lam, b)
    return jw, tw


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("lam", [0.0, 0.2, 1.0])
def test_k1_reduce_plain_matches_jax(d, lam):
    x = deltas(0, 3, d)
    x3 = jops.wire_view(jnp.asarray(x))
    want = np.asarray(jmr.mixed_res_reduce(x3, lam, d, interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jref.mixed_res_reduce_ref(x3, lam, d)))
    got = tmr.mixed_res_reduce(torch.tensor(np.asarray(x3)), lam, d)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("b", [2, 4, 8, 10, 16])
def test_k2_emit_plain_matches_jax(d, b):
    lam = 0.2
    x = deltas(1, 3, d)
    jw = jops.mixed_res_encode(jnp.asarray(x), lam, b, use_kernel=False)
    x3 = jops.wire_view(jnp.asarray(x))
    want = jmr.mixed_res_emit(x3, jw.head, b, d, interpret=True)
    got = tmr.mixed_res_emit(torch.tensor(np.asarray(x3)),
                             torch.tensor(np.asarray(jw.head)), b, d)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("d", DIMS)
def test_k2_emit_anchored_rule_matches_jax(d):
    b = 8
    x = deltas(2, 3, d)
    x3 = jops.wire_view(jnp.asarray(x))
    head = np.zeros((3, 8), np.float32)
    head[:, 0] = 10.0                 # underestimated inf: codes clamp
    head[:, 1] = 1.0
    head[:, 2] = np.float32(9.0) / np.float32(2 ** b - 1)
    want = jref.mixed_res_emit_ref(x3, jnp.asarray(head), b, d,
                                   anchored=True)
    got = tmr.mixed_res_emit(torch.tensor(np.asarray(x3)),
                             torch.tensor(head), b, d, anchored=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ K3
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("b", [4, 10])
def test_k3_dequant_reduce_plain_matches_jax(d, with_acc, b):
    x = deltas(3, 3, d)
    jw, tw = encode_both(x, 0.2, b)
    rng = np.random.default_rng(3)
    w = rng.uniform(0.05, 0.4, 3).astype(np.float32)
    W = jw.signs.shape[1]
    acc = rng.standard_normal((W, 128)).astype(np.float32) \
        if with_acc else None
    jacc = None if acc is None else jnp.asarray(acc)
    kern = np.asarray(jmr.mixed_res_dequant_reduce(
        jw.signs, jw.hi, jw.codes, jw.head, jnp.asarray(w), b, acc=jacc,
        interpret=True))
    oracle = np.asarray(jref.mixed_res_dequant_reduce_ref(
        jw.signs, jw.hi, jw.codes, jw.head, jnp.asarray(w), b, acc=jacc))
    got = tmr.mixed_res_dequant_reduce(
        tw.signs, tw.hi, tw.codes, tw.head, torch.tensor(w), b,
        acc=None if acc is None else torch.tensor(acc)).numpy()
    tol = reduce_tol(w, np.asarray(jw.head))
    np.testing.assert_allclose(got, kern, rtol=0, atol=tol)
    # same fold order as the jnp oracle, so equal on the CPU
    np.testing.assert_array_equal(got, oracle)


# ------------------------------------------------------- the wire path
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("lam", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("b", [2, 10, 16])
def test_encode_matches_jax_bit_for_bit(d, lam, b):
    jw, tw = encode_both(deltas(4, 3, d), lam, b)
    for g, w in zip(tw, jw):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("lam,b", [(0.2, 10), (0.0, 4), (1.0, 16)])
def test_wire_aggregate_matches_jax(d, lam, b):
    U = 4
    x = deltas(5, U, d)
    x[3, :] = -0.75                              # step == 0 grid
    w = np.random.default_rng(5).uniform(0.05, 0.4, U).astype(np.float32)
    jagg, jbits, jaux = jops.mixed_res_wire_aggregate(
        jnp.asarray(x), jnp.asarray(w), lam, b, use_kernel=False)
    tagg, tbits, taux = tops.mixed_res_wire_aggregate(
        torch.tensor(x), torch.tensor(w), lam, b)
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    for k in ("s", "dbar", "dw_q", "inf", "r"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]))
    head = np.asarray(jops.mixed_res_encode(jnp.asarray(x), lam, b,
                                            use_kernel=False).head)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(jagg), rtol=0,
                               atol=reduce_tol(w, head))


@pytest.mark.parametrize("lam,b", [(0.2, 10), (0.05, 8), (0.9, 2)])
def test_wire_roundtrip_equals_golden_reference(lam, b):
    """encode -> decode at weight 1 == the eager golden reference, in
    the port and against the JAX package's."""
    d = 3000
    x = deltas(6, 2, d)[:1]
    agg, bits, _ = tops.mixed_res_wire_aggregate(
        torch.tensor(x), torch.ones(1), lam, b)
    r = mixed_resolution_quantize(torch.tensor(x[0]), lam, b)
    np.testing.assert_array_equal(agg.numpy(), r.recon.numpy())
    assert float(bits[0]) == float(r.bits)
    jr = jax_quantize(jnp.asarray(x[0]), lam, b)
    np.testing.assert_array_equal(r.recon.numpy(), np.asarray(jr.recon))
    assert float(r.bits) == float(jr.bits)


def test_reduce_acc_chains_chunks():
    """Folding the user axis chunk by chunk through ``acc`` gives the
    one-shot fold's values."""
    d, b = 3610, 10
    x = deltas(7, 5, d)
    w = torch.tensor(np.random.default_rng(7).uniform(0.1, 0.3, 5),
                     dtype=torch.float32)
    wire = tops.mixed_res_encode(torch.tensor(x), 0.2, b)
    full = tops.mixed_res_wire_reduce(wire, w, b, d)
    part = lambda lo, hi: tops.MixedResWire(*(a[lo:hi] for a in wire))
    acc = tops.mixed_res_wire_reduce(part(0, 2), w[:2], b, d)
    acc = tops.mixed_res_wire_reduce(part(2, 5), w[2:], b, d, acc=acc)
    assert torch.equal(acc, full)


# --------------------------------------------------- dispatch contract
def test_wrappers_run_plain_versions_on_cpu_tensors():
    """A CPU tensor goes to the plain version and no kernel launches;
    the kernel lowering refuses CPU tensors instead of falling back."""
    before = dict(LAUNCHES)
    x = torch.tensor(deltas(8, 2, 3610))
    wire = tops.mixed_res_encode(x, 0.2, 10)
    tops.mixed_res_wire_reduce(wire, torch.ones(2), 10, 3610)
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tops.mixed_res_encode(x, 0.2, 10, path=WirePath(lowering="kernel"))
    ref = tops.mixed_res_encode(x, 0.2, 10,
                                path=WirePath(lowering="reference"))
    for a, c in zip(wire, ref):
        assert torch.equal(a, c)


@pytest.mark.parametrize("kw", [dict(plane="signplane", cohort_size=8),
                                dict(plane="dense", cohort_size=8),
                                dict(plane="signplane", checksum=True),
                                dict(plane="dense", checksum=True)])
def test_wire_plane_rules_match_jax(kw):
    """Combinations the JAX spec refuses raise its ValueError here too,
    before the knobs' own NotImplementedError."""
    from repro.kernels import WirePath as JWire
    with pytest.raises(ValueError):
        JWire(**kw)
    with pytest.raises(ValueError, match="plane='packed'"):
        WirePath(**kw)


@pytest.mark.parametrize("field,value", [("cohort_size", 8),
                                         ("clusters", 2),
                                         ("budget", object()),
                                         ("checksum", True)])
def test_unported_wire_knobs_raise(field, value):
    """The checksum is still unported and raises; cohorts, clusters and
    budgets are ported and follow JAX's spec: a cohort size builds and
    streams, clusters need a cohort size and a budget must be a
    LayerBudget (JAX's ValueErrors)."""
    from repro.kernels import WirePath as JWire
    if field == "checksum":
        with pytest.raises(NotImplementedError):
            WirePath(**{field: value})
    elif field == "cohort_size":
        wp, jwp = WirePath(cohort_size=value), JWire(cohort_size=value)
        assert wp.streaming and jwp.streaming
        assert wp.effective_budget is jwp.effective_budget is None
    else:
        with pytest.raises(ValueError):
            JWire(**{field: value})
        with pytest.raises(ValueError):
            WirePath(**{field: value})


def test_wrapper_input_checks():
    with pytest.raises(ValueError, match=r"\[U, W, 128\]"):
        tmr.mixed_res_reduce(torch.zeros(2, 4, 64), 0.2, 10)
    with pytest.raises(ValueError, match="d_valid"):
        tmr.mixed_res_reduce(torch.zeros(2, 4, 128), 0.2, 4 * 128 + 1)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tops.mixed_res_encode(torch.zeros(1, 2 ** 24), 0.2, 8)


def test_u32_boundary_roundtrip():
    v = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                     dtype=torch.int64)
    u = tref.to_u32(v)
    assert u.dtype == torch.uint32
    np.testing.assert_array_equal(u.numpy(),
                                  np.array(v.numpy(), dtype=np.uint32))
    assert torch.equal(tref.from_u32(u), v)


def test_code_width_matches_jax():
    for b in range(2, 17):
        assert tmr.code_width(b) == jmr.code_width(b)
        assert tmr.code_words_per_row(b) == jmr.code_words_per_row(b)
    with pytest.raises(ValueError):
        tmr.code_width(17)
    for d in (1, 128, 3610, 32768, 32769, 462410):
        assert tops.sign_pad_len(d) == jops.sign_pad_len(d)

"""How the port's wrappers cut their launches, on the CPU: K1 and K2 over
more users than one launch takes, and K5's staging plan.

* K1 and K2 put the users on ``gridDim.y`` (at most 65,535 a launch);
  the wrappers launch larger U in chunks of :func:`mixed_res.user_chunks`.
  The JAX kernels have no limit on users, so at U = 65,536 the port's
  wrappers on CPU tensors (their plain versions) are held bit for bit to
  the JAX kernels' jnp oracles, which equal the Pallas kernels in
  interpret mode (``tests/test_torch_kernels.py``).
* K5 stages each block's words a chunk of peers at a time;
  :func:`quant_pack.staging_order` is the twin of the kernel's copies,
  and every (peer, row) must be staged once, peers ascending within a
  row (the fold order the bits depend on).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mixed_res as tmr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_pack as tqp
from repro_torch.kernels import ref as tref


# ---------------------------------------------------------------- users
@pytest.mark.parametrize("U", [1, 65535, 65536, 131071, 200000])
def test_user_chunks_cover_every_user_once(U):
    chunks = tmr.user_chunks(U)
    assert chunks[0][0] == 0 and chunks[-1][1] == U
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    sizes = [u1 - u0 for u0, u1 in chunks]
    assert min(sizes) >= 1 and max(sizes) <= tmr.MAX_USERS_PER_LAUNCH
    assert len(chunks) == -(-U // tmr.MAX_USERS_PER_LAUNCH)
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("d", [100, 128])
def test_k1_k2_past_one_launch_of_users_match_jax(d):
    """U = 65,536 users of one row (W = 1; d = 100 masked, d = 128 not):
    the wrappers on CPU tensors take any U and equal the JAX oracles."""
    U, lam, b = 65536, 0.2, 10
    rng = np.random.default_rng(d)
    x = rng.standard_normal((U, d)).astype(np.float32)
    x[:, rng.choice(d, size=2, replace=False)] *= 50.0
    x[np.abs(x) < np.finfo(np.float32).tiny] = 0.0
    x[1] = 0.0
    x3 = jops.wire_view(jnp.asarray(x))
    assert x3.shape == (U, 1, 128)
    t3 = torch.tensor(np.asarray(x3))
    np.testing.assert_array_equal(
        tmr.mixed_res_reduce(t3, lam, d).numpy(),
        np.asarray(jref.mixed_res_reduce_ref(x3, lam, d)))
    head = jops.mixed_res_encode(jnp.asarray(x), lam, b,
                                 use_kernel=False).head
    for anchored in (False, True):
        got = tmr.mixed_res_emit(t3, torch.tensor(np.asarray(head)), b, d,
                                 anchored=anchored)
        want = jref.mixed_res_emit_ref(x3, head, b, d, anchored=anchored)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tops.mixed_res_encode(torch.tensor(x), lam, b).head.numpy(),
        np.asarray(head))


# ---------------------------------------------------------------- K5
@pytest.mark.parametrize("W", [1, 29, 3840])
@pytest.mark.parametrize("G", [1, 31, 32, 33, 40, 1000])
def test_k5_stages_every_peer_of_every_row_once_in_order(G, W):
    plan = tqp.sign_reduce_plan(G, W)
    assert plan.blocks * plan.rows >= W > (plan.blocks - 1) * plan.rows
    assert plan.chunks * plan.chunk >= G > (plan.chunks - 1) * plan.chunk
    assert plan.chunk * plan.rows_a_warp == 32      # a piece a lane
    assert plan.rows % plan.rows_a_warp == 0        # whole warps a block
    g, row = tqp.staging_order(plan)
    assert len(g) == G * W
    assert np.unique(row * G + g).size == G * W
    assert g.min() == 0 and g.max() == G - 1
    assert row.min() == 0 and row.max() == W - 1
    order = np.argsort(row, kind="stable")
    g, row = g[order], row[order]
    same_row = np.diff(row) == 0
    assert np.all(np.diff(g)[same_row] > 0)


def test_k5_plan_depends_on_shapes_alone_and_refuses_empty():
    assert tqp.sign_reduce_plan(40, 3840) == tqp.sign_reduce_plan(40, 3840)
    assert tqp.sign_reduce_plan(40, 3840).blocks == 3840 // tqp.K5_ROWS
    for G, W in ((0, 8), (3, 0)):
        with pytest.raises(ValueError, match="K5 needs"):
            tqp.sign_reduce_plan(G, W)


def test_k5_plain_keeps_a_single_negative_zero():
    """G = 1 with a scale of 0: a clear bit gives -0.0, a set bit +0.0;
    the fold starts from the first term, never from 0.0."""
    words = torch.tensor([[[0x0000FFFF, 0, 0xFFFFFFFF, 1]]],
                         dtype=torch.int64)
    words = tref.to_u32(words)
    out = tqp.sign_dequant_reduce(words, torch.zeros(1))
    signs = torch.signbit(out[0])
    want = torch.ones(128, dtype=torch.bool)
    want[:16] = False
    want[64:97] = False
    assert torch.equal(signs, want)
    assert torch.all(out == 0.0)

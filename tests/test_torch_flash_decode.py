"""Parity of the port's flash-decode attention (K6) with the JAX
package, on the CPU, where the port's wrapper and op run the plain
PyTorch version its CUDA kernel is held to on the card.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance (absolute and relative), the JAX battery's own
(``tests/test_kernels.py``): 1e-5 for float32, 2e-2 for bfloat16 — the
plain version sums in another order than the Pallas kernel's blocked
online softmax, and bfloat16 outputs round once more.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro_torch.kernels import LAUNCHES, flash_decode_op, ops, ref
from repro_torch.kernels import flash_decode as fd

BATTERY = [   # tests/test_kernels.py:75-80, with its kv_block of 256
    (1, 1, 1, 512, 64, 64, "float32"),
    (2, 4, 2, 1024, 128, 128, "float32"),
    (2, 2, 8, 2048, 64, 64, "bfloat16"),
    (1, 8, 5, 512, 128, 64, "float32"),     # uneven group, Dv != D
]


def tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-5


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def to_jax(a, dtype):
    return jnp.asarray(a, dtype=jnp.dtype(dtype))


def to_torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol(dtype), atol=tol(dtype))


@pytest.mark.parametrize("B,Hkv,G,S,D,Dv,dtype", BATTERY)
@pytest.mark.parametrize("length_of", ["S-17", "3", "S"])
def test_plain_k6_matches_jax_kernel_and_oracle(B, Hkv, G, S, D, Dv, dtype,
                                                length_of):
    """The port's wrapper on CPU tensors (the plain version) against the
    JAX Pallas kernel in interpret mode and the JAX oracle."""
    length = {"S-17": S - 17, "3": 3, "S": S}[length_of]
    q, k, v = arrays(S + G, (B, Hkv, G, D), (B, Hkv, S, D), (B, Hkv, S, Dv))
    n = jnp.asarray(length, jnp.int32)
    want_kernel = jflash_decode(to_jax(q, dtype), to_jax(k, dtype),
                                to_jax(v, dtype), n, kv_block=256,
                                interpret=True)
    want_oracle = jref.flash_decode_ref(to_jax(q, dtype), to_jax(k, dtype),
                                        to_jax(v, dtype), n)
    before = dict(LAUNCHES)
    got = fd.flash_decode(to_torch(q, dtype), to_torch(k, dtype),
                          to_torch(v, dtype), torch.tensor(length))
    assert LAUNCHES == before          # CPU tensors launch nothing
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, Hkv, G, Dv)
    close(got.float(), want_kernel, dtype)
    close(got.float(), want_oracle, dtype)


def test_plain_k6_short_length():
    """Masking: only the first 3 cache entries count (kv_block 128)."""
    q, k, v = arrays(7, (1, 1, 1, 64), (1, 1, 512, 64), (1, 1, 512, 64))
    n = jnp.asarray(3, jnp.int32)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n,
                         kv_block=128, interpret=True)
    got = ref.flash_decode_ref(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), 3)
    close(got, want, "float32")
    # the first three positions alone give the same answer
    short = ref.flash_decode_ref(torch.tensor(q), torch.tensor(k[:, :, :3]),
                                 torch.tensor(v[:, :, :3]), 3)
    close(got, short, "float32")


@pytest.mark.parametrize("B,H,Hkv,S,D,Dv,dtype", [
    (2, 8, 2, 1024, 64, 64, "float32"),       # tests/test_kernels.py:112
    (2, 32, 8, 640, 128, 128, "bfloat16"),    # granite's grouping, S % 512 > 0
    (1, 40, 8, 512, 128, 128, "float32"),     # qwen3-14b's G = 5
])
@pytest.mark.parametrize("length", [1, 300, None])
def test_flash_decode_op_gqa_layout(B, H, Hkv, S, D, Dv, dtype, length):
    """ops wrapper: [B,H,D] x [B,S,Hkv,D] cache layout against the JAX
    op (interpret) and the JAX oracle on the transposed caches."""
    length = S if length is None else length
    q, k, v = arrays(H + S, (B, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv))
    n = jnp.asarray(length, jnp.int32)
    want_op = jops.flash_decode_op(to_jax(q, dtype), to_jax(k, dtype),
                                   to_jax(v, dtype), n, kv_block=128,
                                   interpret=True)
    want = jref.flash_decode_ref(
        to_jax(q, dtype).reshape(B, Hkv, H // Hkv, D),
        to_jax(k, dtype).transpose(0, 2, 1, 3),
        to_jax(v, dtype).transpose(0, 2, 1, 3), n).reshape(B, H, Dv)
    got = flash_decode_op(to_torch(q, dtype), to_torch(k, dtype),
                          to_torch(v, dtype),
                          torch.tensor(length, dtype=torch.int32))
    assert tuple(got.shape) == (B, H, Dv)
    close(got.float(), want_op, dtype)
    close(got.float(), want, dtype)


def test_op_casts_a_cache_of_another_dtype_like_jax():
    """A bf16 cache under an f32 query is cast to the query's dtype, as
    the JAX decode path's ``ck.astype(dt)``."""
    q, k, v = arrays(3, (1, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64))
    kb = to_torch(k, "bfloat16")
    vb = to_torch(v, "bfloat16")
    got = flash_decode_op(torch.tensor(q), kb, vb, 200)
    want = flash_decode_op(torch.tensor(q), kb.float(), vb.float(), 200)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_op_reads_caches_through_views(monkeypatch):
    """The op hands K6 transposed views of the cache, not copies."""
    seen = {}
    orig = ops.flash_decode

    def spy(q, k, v, length):
        seen["k"], seen["v"] = k, v
        return orig(q, k, v, length)

    q, k, v = arrays(4, (1, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64))
    kt, vt = torch.tensor(k), torch.tensor(v)
    monkeypatch.setattr(ops, "flash_decode", spy)
    flash_decode_op(torch.tensor(q), kt, vt, 64)
    assert seen["k"].data_ptr() == kt.data_ptr()
    assert seen["v"].data_ptr() == vt.data_ptr()
    assert tuple(seen["k"].shape) == (1, 2, 128, 64)


def H100_CLUSTERS(n):
    """Clusters of n blocks resident at once, as the card reports for K6
    (one block on each of 132 SMs)."""
    return 132 // n


@pytest.mark.parametrize("B,Hkv,S", [
    (8, 8, 4096),       # the serve shape: 2 splits, 128 blocks
    (128, 8, 32768),    # decode_32k: B*Hkv already fills the card
    (2, 8, 777),
    (2, 4, 1000),
])
@pytest.mark.parametrize("length_of", ["1", "3", "tile", "S-17", "S"])
def test_split_ranges(B, Hkv, S, length_of):
    """The range arithmetic each block does on the device from
    ``*length``: the active splits tile [0, length) exactly in whole
    tiles, none empty, one split below a tile; the grid, fixed by
    shapes alone, is whole clusters of at most CLUSTER_MAX blocks."""
    length = {"1": 1, "3": 3, "tile": fd.TILE, "S-17": S - 17,
              "S": S}[length_of]
    nsplit = fd.split_count(B, Hkv, S, H100_CLUSTERS)
    assert 1 <= nsplit <= fd.CLUSTER_MAX
    assert nsplit == 1 or B * Hkv <= H100_CLUSTERS(nsplit)   # one wave
    assert (nsplit * Hkv * B) % nsplit == 0
    assert (nsplit - 1) * fd.MIN_CHUNK < S      # every split can have work
    n_eff, ranges = fd.split_ranges(length, S, nsplit)
    assert len(ranges) == nsplit and 1 <= n_eff <= nsplit
    if length < fd.TILE:
        assert n_eff == 1
    active = ranges[:n_eff]
    assert all(s < e for s, e in active)
    assert all(s % fd.TILE == 0 for s, _ in active)
    assert active[0][0] == 0 and active[-1][1] == length
    assert all(e1 == s2 for (_, e1), (s2, _) in zip(active, active[1:]))
    assert all(s == e for s, e in ranges[n_eff:])
    tiles = [-(-(e - s) // fd.TILE) for s, e in active]
    assert max(tiles) - min(tiles) <= 1          # shared evenly
    if length == S and length >= nsplit * fd.MIN_CHUNK:
        assert n_eff == nsplit
    if (B, Hkv, S) == (8, 8, 4096):
        assert nsplit == 2
    if (B, Hkv, S) == (128, 8, 32768):
        assert nsplit == 1


def test_wrapper_rejects_bad_shapes():
    q, k, v = (torch.zeros(1, 2, 2, 64), torch.zeros(1, 2, 8, 64),
               torch.zeros(1, 2, 8, 64))
    with pytest.raises(ValueError, match="4-d"):
        fd.flash_decode(q[0], k, v, 4)
    with pytest.raises(ValueError, match="shapes disagree"):
        fd.flash_decode(q, k[:, :1], v, 4)
    with pytest.raises(ValueError, match="group"):
        flash_decode_op(torch.zeros(1, 3, 64), k.transpose(1, 2),
                        v.transpose(1, 2), 4)

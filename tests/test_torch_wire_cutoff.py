"""The division-free threshold rule of K1 and K2, and K1's cluster layout,
on the CPU.

K1 and K2 decide ``|x| / safe_inf >= lam`` by a per-user cutoff: the
f32 ``a = |x|`` that pass are exactly ``lo <= a <= hi``.
``ref.threshold_cutoff`` is the plain twin of the search the kernels
run; here it is held to the plain versions' division over random,
subnormal, zero, NaN and infinite ``inf``, the issue's ``lam`` values,
and ``a`` at 0, subnormals, +inf, NaN and the bit patterns next to the
cutoff.  A reduce and an emit written with the cutoff are held to the
plain versions and to the JAX package's kernels.  ``rank_rows`` is
K1's partition of a user's rows over the ranks of its cluster, and
``reduce_config`` its choice of cluster size and staging depth.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mixed_res as jmr
from repro.kernels import ops as jops
from repro_torch.kernels import mixed_res as tmr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_MAX = float(np.finfo(np.float32).max)
LAMS = [0.0, 0.2, 1.0, 1e-30, 0.999999, -0.5]
INFS = {"normal": 225.30078, "small": 3.7e-20, "near max": 3.0e38,
        "subnormal": 1.0e-40, "least subnormal": 1.4e-45, "zero": 0.0,
        "nan": math.nan, "inf": math.inf}


def bits(v):
    return int(np.float32(v).view(np.uint32))


def f32(b):
    return np.array(b, dtype=np.uint32).view(np.float32)[()]


def plain_rule(a: np.ndarray, inf: float, lam: float) -> np.ndarray:
    """The plain versions' threshold rule, as ``ref.py`` spells it."""
    inf_t = torch.tensor([inf], dtype=torch.float32)
    safe = torch.where(inf_t > 0, inf_t, 1.0)
    absx = torch.abs(torch.tensor(a, dtype=torch.float32))
    return ((absx / safe) >= float(np.float32(lam))).numpy()


def probe_values(lo: float, seed: int) -> np.ndarray:
    """|x| values: random over the whole f32 range, 0, -0.0, subnormals,
    FLT_MAX, +inf, NaN, and the 81 patterns around the cutoff ``lo``."""
    rng = np.random.default_rng(seed)
    a = (10.0 ** rng.uniform(-45, 38.5, 4000)).astype(np.float32)
    special = np.array([0.0, -0.0, 1.4e-45, 2.8e-45, 1e-40, 1.1754942e-38,
                        1.1754944e-38, F32_MAX, math.inf, math.nan,
                        -math.inf], np.float32)
    near = []
    if math.isfinite(lo):
        b = bits(lo)
        near = [f32(b + k) for k in range(-40, 41) if 0 <= b + k <= 0x7F800000]
    return np.concatenate([a, special, np.array(near, np.float32)])


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("kind", list(INFS))
def test_cutoff_equals_the_division(kind, lam):
    inf = INFS[kind]
    lo, hi = tref.threshold_cutoff(inf, lam)
    a = np.abs(probe_values(lo, seed=len(kind)))
    got = (a >= np.float32(lo)) & (a <= np.float32(hi))
    np.testing.assert_array_equal(got, plain_rule(a, inf, lam))


@pytest.mark.parametrize("lam,want", [(0.0, (0.0, F32_MAX)),
                                      (-0.5, (0.0, F32_MAX)),
                                      (0.2, None), (1e-30, None)])
def test_infinite_max_passes_every_finite_value_or_none(lam, want):
    """safe_inf = +inf: finite |x| divide to 0 and +inf to NaN, so with
    lam <= 0 every finite value passes and +inf does not; else none."""
    lo, hi = tref.threshold_cutoff(math.inf, lam)
    if want is None:
        assert math.isnan(lo) and math.isnan(hi)
    else:
        assert (lo, hi) == want
        assert plain_rule(np.array([F32_MAX, math.inf], np.float32),
                          math.inf, lam).tolist() == [True, False]


def test_cutoff_is_the_least_passing_pattern():
    """Over random (inf, lam) pairs the cutoff passes and the pattern
    below it does not: the least passing pattern, as the kernels'
    32-way search finds it."""
    rng = np.random.default_rng(0)
    infs = (10.0 ** rng.uniform(-45, 38.5, 500)).astype(np.float32)
    lams = np.array(LAMS + [float(v) for v in rng.uniform(0, 1, 10)],
                    np.float32)[rng.integers(0, len(LAMS) + 10, 500)]
    for inf, lam in zip(infs, lams):
        lo, hi = tref.threshold_cutoff(float(inf), float(lam))
        if math.isnan(lo) or lo == 0.0:
            continue
        assert hi == math.inf
        below = np.array([f32(bits(lo) - 1), lo], np.float32)
        assert plain_rule(below, float(inf), float(lam)).tolist() \
            == [False, True]


def test_cutoffs_wrapper_runs_the_twin_on_cpu():
    inf = torch.tensor([225.3, 0.0, math.nan, math.inf, 1e-40])
    lam = torch.tensor([0.2, 0.2, 1.0, 0.0, 1.0])
    got = tmr.cutoffs(inf, lam)
    want = [tref.threshold_cutoff(float(i), float(m))
            for i, m in zip(inf.tolist(), lam.tolist())]
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))
    with pytest.raises(ValueError, match=r"\[n >= 1\]"):
        tmr.cutoffs(inf, lam[:2])


# ------------------------------------------- K1 and K2 with the cutoff
def deltas(seed, U, d, specials):
    """Heavy-tailed f32 deltas, user 1 all zero; with ``specials`` user 0
    holds NaN, +-inf, +-subnormals and -0.0, user 2 +-inf (an infinite
    max), user 3 only subnormals (a subnormal max)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((U, d)).astype(np.float32)
    x[:, rng.choice(d, size=max(1, d // 64), replace=False)] *= 50.0
    x[1] = 0.0
    if specials:
        x[0, :6] = [math.nan, math.inf, -math.inf, 1.4e-45, -1.4e-45, -0.0]
        x[2, 5:7] = [math.inf, -math.inf]
        x[3] = (rng.standard_normal(d) * 1e-39).astype(np.float32)
    return x


def reduce_by_cutoff(x3: torch.Tensor, lam: float, d: int) -> torch.Tensor:
    """K1's arithmetic on the CPU: the max on bit patterns, the cutoff,
    then count and min over the valid elements inside it."""
    U, W, _ = x3.shape
    flat = x3.reshape(U, -1)
    absx = torch.abs(flat)
    valid = torch.arange(W * 128) < d
    head = torch.zeros((U, 8), dtype=torch.float32)
    for u in range(U):
        bits_u = absx[u].view(torch.int32)
        inf = bits_u.max().view(torch.float32)
        lo, hi = tref.threshold_cutoff(float(inf), lam)
        hi_set = (absx[u] >= lo) & (absx[u] <= hi) & valid
        head[u, tmr.H_INF] = inf
        head[u, tmr.H_DWQ] = absx[u][hi_set].min() if hi_set.any() \
            else math.inf
        head[u, tmr.H_DBAR] = float(hi_set.sum())
    return head


@pytest.mark.parametrize("d", [3610, 65500])
@pytest.mark.parametrize("lam", [0.0, 0.2, 1.0])
def test_reduce_by_cutoff_equals_plain_and_jax(d, lam):
    x = deltas(d, 5, d, specials=False)
    x3 = tops.wire_view(torch.tensor(x)).contiguous()
    got = reduce_by_cutoff(x3, lam, d)
    torch.testing.assert_close(got, tref.mixed_res_reduce_ref(x3, lam, d),
                               rtol=0, atol=0)
    jx3 = jops.wire_view(jnp.asarray(x))
    want = np.asarray(jmr.mixed_res_reduce(jx3, lam, d, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [3610, 65500])
@pytest.mark.parametrize("lam", [0.0, 0.2, 1.0])
def test_cutoff_rules_special_values_like_plain(d, lam):
    """With NaN, +-inf, subnormals and -0.0 in the users: the cutoff's
    reduce equals the plain reduce (a NaN max compared as NaN), and the
    cutoff's hi plane equals the plain emit's."""
    x3 = tops.wire_view(torch.tensor(deltas(d + 1, 5, d, specials=True))
                        ).contiguous()
    got = reduce_by_cutoff(x3, lam, d)
    want = tref.mixed_res_reduce_ref(x3, lam, d)
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got.nan_to_num(0.0), want.nan_to_num(0.0),
                               rtol=0, atol=0)
    wire = tops.mixed_res_encode(x3.reshape(5, -1)[:, :d], lam, 10)
    absx = torch.abs(x3)
    valid = (torch.arange(x3.shape[1] * 128) < d).reshape(1, -1, 128)
    hi_set = torch.zeros_like(valid.expand(5, -1, -1))
    for u in range(5):
        lo, hi = tref.threshold_cutoff(float(wire.head[u, tmr.H_INF]),
                                       float(wire.head[u, tmr.H_LAM]))
        hi_set[u] = (absx[u] >= lo) & (absx[u] <= hi) & valid[0]
    assert torch.equal(tref._pack(hi_set.to(torch.int64), 1), wire.hi)


# ---------------------------------------------------------- K1 layout
@pytest.mark.parametrize("W", [1, 29, 512, 3840, 131072])
@pytest.mark.parametrize("n", [1, 2, 8, 16])
def test_rank_rows_cover_every_row_once(W, n):
    ranges = tmr.rank_rows(W, n)
    assert len(ranges) == n
    rows = [r for lo, hi in ranges for r in range(lo, hi)]
    assert rows == list(range(W))
    T = -(-W // tmr.K1_TILE_ROWS)
    busy = [hi - lo for lo, hi in ranges if hi > lo]
    assert len(busy) == min(n, T)
    # whole tiles, the last rank's range cut at W
    assert all(lo % tmr.K1_TILE_ROWS == 0 for lo, hi in ranges if hi > lo)
    assert max(busy) - min(busy[:-1] or busy) <= tmr.K1_TILE_ROWS


def test_rank_rows_leave_most_ranks_empty_at_w29():
    ranges = tmr.rank_rows(29, 16)
    assert ranges[:2] == [(0, 16), (16, 29)]
    assert all(lo == hi for lo, hi in ranges[2:])


@pytest.mark.parametrize("W,held,want", [
    (3840, {16: 21}, (16, 7)),        # the main shape: 15 tiles a rank
    (29, {16: 40}, (16, 1)),          # two tiles: ranks stage one at most
    (512, {16: 0, 8: 30}, (8, 4)),    # no cluster of 16 placed
    (131072, {16: 21}, (16, 7)),      # d near 2**24: 512 tiles a rank
])
def test_reduce_config(W, held, want):
    asked = []

    def clusters_of(n, cap):
        asked.append((n, cap))
        return held.get(n, 0)

    assert tmr.reduce_config(W, clusters_of) == want
    assert asked[-1] == want


def test_reduce_config_raises_when_no_cluster_fits():
    with pytest.raises(RuntimeError, match="no K1 cluster"):
        tmr.reduce_config(3840, lambda n, cap: 0)

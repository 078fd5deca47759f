"""The port's benchmark power controllers (Dinkelbach, max-sum-rate) and
the rate-aware bit allocation against the JAX package's.  Both are host
numpy on a host numpy channel, so the same channel and bits must give
the same arrays, exactly; each package solves on its own
``make_channel`` at the same seed."""
import numpy as np
import pytest

from repro.core import power as jpower
from repro.core.channel import CFmMIMOConfig as JChanCfg
from repro.core.channel import make_channel as jmake_channel
from repro_torch.core import power as tpower
from repro_torch.core.channel import CFmMIMOConfig, make_channel

# reduced iterations: the finite-difference gradient costs K + 1 SINR
# evaluations a step
REDUCED = {"dinkelbach": dict(outer=3, inner=4),
           "max-sum-rate": dict(iters=6, restarts=1)}


def channels(K, seed):
    cfg = dict(M=16, N=4, K=K)
    return (jmake_channel(JChanCfg(**cfg), seed=seed),
            make_channel(CFmMIMOConfig(**cfg), seed=seed))


def test_registry_holds_the_jax_names():
    assert list(tpower.POWER_CONTROLLERS) == list(jpower.POWER_CONTROLLERS)
    for name in tpower.POWER_CONTROLLERS:
        assert tpower.make_power_controller(name).name == name
    with pytest.raises(KeyError, match="max-sum-rate"):
        tpower.make_power_controller("water-filling")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("K", [8, 40])
@pytest.mark.parametrize("name", ["dinkelbach", "max-sum-rate"])
def test_controllers_equal_jax(name, K, seed):
    jc, tc = channels(K, seed)
    bits = np.random.default_rng(seed).uniform(1e5, 2e6, K)
    js = jpower.make_power_controller(name, **REDUCED[name]).solve(jc, bits)
    ts = tpower.make_power_controller(name, **REDUCED[name]).solve(tc, bits)
    for field in ("p", "rates", "latencies"):
        a, b = getattr(js, field), getattr(ts, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert js.info == ts.info
    assert js.straggler_latency == ts.straggler_latency


def test_dinkelbach_stops_early_as_jax_does():
    """A loose tolerance ends the outer loop at its first test."""
    jc, tc = channels(8, 1)
    bits = np.full(8, 4e5)
    kw = dict(outer=5, inner=3, tol=1e9)
    js = jpower.DinkelbachPowerControl(**kw).solve(jc, bits)
    ts = tpower.DinkelbachPowerControl(**kw).solve(tc, bits)
    assert ts.info["dinkelbach_iters"] == js.info["dinkelbach_iters"] == 1
    np.testing.assert_array_equal(js.p, ts.p)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("K", [8, 40])
def test_bit_allocation_equals_jax(K, seed):
    _, tc = channels(K, seed)
    rates = tc.rates(np.ones(K))
    d, b = 462410, 4
    for s_floor in (0.0, 0.05, 0.3):
        a = jpower.equalizing_target_latency(rates, d, b, s_floor)
        c = tpower.equalizing_target_latency(rates, d, b, s_floor)
        assert a == c
        for target in (0.5 * a, a, 2.0 * a):
            np.testing.assert_array_equal(
                jpower.rate_aware_fractions(rates, d, b, target, 0.01, 0.9),
                tpower.rate_aware_fractions(rates, d, b, target, 0.01, 0.9))

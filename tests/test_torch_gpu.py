"""The CUDA kernels K1–K6, the port's engine and its decoder on an
NVIDIA GPU.

Every test here needs the card: the ``cuda`` fixture skips without one,
so the module collects the same tests everywhere.  K1 and K2 are also
held bit for bit at special values (NaN, +-inf, subnormals, -0.0), at
d just under 2**24 and replayed from a CUDA graph.  Run on a machine
with the card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

No jax here: the machine with the card has none.  Each kernel is held
to its plain PyTorch version on the same CUDA inputs — planes, headers,
sign words and the reduces bit for bit; K6, whose sums run in another
order, within 1e-5 (f32) and 2e-2 (bf16).  K5 also at scales of 0.0,
-0.0, subnormals, +-inf and NaN, at G from 1 to 1000 and replayed from
a CUDA graph; K1 and K2 past one launch of users (U = 65,536).  The
paper's baseline quantizers (classic, top-q, LAQ, AQUILA) on the card
against the CPU, and their rounds on the card's dense plane.  The
engine's exact mode bit for bit ``run_fl_sequential`` on the card; K3
and K5 at absent users' zero weights and scales; churn rounds on the
three planes with each K1-K5 launch held to its plain version.  The
batched power solvers on the card against the CPU in float64; the
replicated packed and signplane steps with each K1-K5 launch held to its
plain version and replicate 0 the unreplicated run; the replicate vmap
against the loop over replicates.  Streaming cohorts (launches a
cohort, C >= K bit for bit the vectorized step, the fold through K3's
``acc`` equal to the one-shot K3), AP clusters, the cohort peak memory,
K1-K3 at the per-layer budget's segment shapes and its rounds, async
rounds with K3 over 2K slots and the sync reduction; and
``chip_smoke.py``'s phases of those modes themselves.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import (WireSpy, agg_tol, baseline_card_vs_cpu,
                           bits_equal, card_vs_cpu_rounds, churn_rounds,
                           payload_rule, run_mismatches, same_bits)

from repro_torch.core.quantize import MixedResolutionQuantizer, make_quantizer
from repro_torch.kernels import LAUNCHES, WirePath, reset_launch_counts
from repro_torch.kernels import mixed_res as mr
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, quant_pack as qp, ref
from repro_torch.sim import get_scenario, make_engine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def deltas(seed, U, d, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((U, d)).astype(np.float32)
    x[:, rng.choice(d, size=max(1, d // 64), replace=False)] *= 50.0
    x[1] = 0.0
    return torch.tensor(x, device=device)


@pytest.mark.parametrize("d", [3610, 65500])
@pytest.mark.parametrize("lam,b", [(0.0, 2), (0.2, 10), (1.0, 16), (0.2, 4)])
def test_kernels_equal_plain_versions(cuda, d, lam, b):
    x3 = ops.wire_view(deltas(0, 3, d, cuda)).contiguous()
    reset_launch_counts()
    head = mr.mixed_res_reduce(x3, lam, d)
    assert bits_equal(head, ref.mixed_res_reduce_ref(x3, lam, d))
    wire = ops.mixed_res_encode(x3.reshape(3, -1)[:, :d], lam, b,
                                path=WirePath(lowering="kernel"))
    plain = ops.mixed_res_encode(x3.reshape(3, -1)[:, :d], lam, b,
                                 path=WirePath(lowering="reference"))
    for k, p in zip(wire, plain):
        assert bits_equal(k, p)
    w = torch.tensor([0.2, 0.3, 0.5], device=cuda)
    acc = torch.randn(x3.shape[1], 128, device=cuda)
    for a in (None, acc):
        got = mr.mixed_res_dequant_reduce(*wire[:4], w, b, acc=a)
        want = ref.mixed_res_dequant_reduce_ref(*wire[:4], w, b, acc=a)
        assert bits_equal(got, want)
    torch.cuda.synchronize()
    # K1 is one launch a call: the direct call and the kernel encode's
    assert LAUNCHES == {"mixed_res_reduce": 2, "mixed_res_emit": 1,
                        "mixed_res_dequant_reduce": 2, "signpack": 0,
                        "sign_dequant_reduce": 0, "flash_decode": 0}


def special_deltas(seed, U, d, device):
    """:func:`deltas` with special values: user 0 holds NaN, +-inf,
    +-subnormals and -0.0; user 2 +-inf (an infinite max); user 3 only
    subnormals (a subnormal max); user 1 stays all zero."""
    x = deltas(seed, U, d, device)
    nan, inf = float("nan"), float("inf")
    x[0, :6] = torch.tensor([nan, inf, -inf, 1.4e-45, -1.4e-45, -0.0])
    if U > 3:
        x[2, 5:7] = torch.tensor([inf, -inf])
        x[3] = x[3] * 1e-39
    return x


def k1_k2_exact(x, lam, b):
    """K1, the kernel encode (K1, epilogue, K2) and K2 on the anchored
    rule against their plain versions on the same CUDA inputs, bit for
    bit."""
    U, d = x.shape
    x3 = ops.wire_view(x).contiguous()
    head = mr.mixed_res_reduce(x3, lam, d)
    assert bits_equal(head, ref.mixed_res_reduce_ref(x3, lam, d))
    wire = ops.mixed_res_encode(x, lam, b, path=WirePath(lowering="kernel"))
    plain = ops.mixed_res_encode(x, lam, b,
                                 path=WirePath(lowering="reference"))
    for k, p in zip(wire, plain):
        assert bits_equal(k, p)
    got = mr.mixed_res_emit(x3, wire.head, b, d, anchored=True)
    want = ref.mixed_res_emit_ref(x3, wire.head, b, d, anchored=True)
    for k, p in zip(got, want):
        assert bits_equal(k, p)


@pytest.mark.parametrize("d", [3610, 65500])
@pytest.mark.parametrize("lam", [0.0, 0.2, 1.0])
def test_k1_k2_special_values_equal_plain_versions(cuda, d, lam):
    """NaN, +-inf, subnormals, -0.0, an infinite max, a subnormal max
    and an all-zero user; W = 29 (most of K1's ranks empty) and 512."""
    reset_launch_counts()
    k1_k2_exact(special_deltas(d + 7, 5, d, cuda), lam, 10)
    torch.cuda.synchronize()
    assert LAUNCHES["mixed_res_reduce"] == 2
    assert LAUNCHES["mixed_res_emit"] == 2


def test_k1_k2_near_2_24(cuda):
    """d = 16,777,000, just under 2**24: most of each user's row lies
    beyond K1's staged tiles and is read again from L2 or memory."""
    x = special_deltas(3, 2, 16_777_000, cuda)
    for lam in (0.0, 0.2, 1.0):
        k1_k2_exact(x, lam, 10)
    torch.cuda.synchronize()


def test_k1_k2_replay_from_a_cuda_graph(cuda):
    """K1 and K2 captured once in a CUDA graph (the launch configuration
    is asked of the card at the first call, before capture) replay to
    the plain versions' bits, on new deltas copied in place."""
    U, d, b, lam = 8, 462410, 10, 0.2
    x3 = ops.wire_view(deltas(4, U, d, cuda)).contiguous()
    head = ops.mixed_res_encode(x3.reshape(U, -1)[:, :d], lam, b).head

    def both():
        return mr.mixed_res_reduce(x3, lam, d), \
            mr.mixed_res_emit(x3, head, b, d)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stats, planes = both()
    for seed in (5, 6):
        x3.copy_(ops.wire_view(deltas(seed, U, d, cuda)))
        graph.replay()
        torch.cuda.synchronize()
        assert bits_equal(stats, ref.mixed_res_reduce_ref(x3, lam, d))
        for k, p in zip(planes, ref.mixed_res_emit_ref(x3, head, b, d)):
            assert bits_equal(k, p)


def test_cutoffs_on_card_equal_the_twin(cuda):
    """The cutoff search K1 and K2 run, on 4000 (inf, lam) pairs from
    the least subnormal to 3e38, zero, NaN and +inf, against the numpy
    bisection in ``ref.threshold_cutoff``."""
    rng = np.random.default_rng(0)
    inf = (10.0 ** rng.uniform(-45, 38.5, 4000)).astype(np.float32)
    inf[:6] = [0.0, np.nan, np.inf, 1.4e-45, 3e38, np.inf]
    lam = np.array([0.0, 0.2, 1.0, 1e-30, 0.999999, -1.0, np.nan],
                   np.float32)[rng.integers(0, 7, 4000)]
    got = mr.cutoffs(torch.tensor(inf, device=cuda),
                     torch.tensor(lam, device=cuda))
    want = mr.cutoffs(torch.tensor(inf), torch.tensor(lam))
    assert bits_equal(got.cpu(), want)


def test_k1_cluster_config_on_card(cuda):
    """The card places K1's clusters of 16 at the main shape, and a
    configuration it cannot launch raises."""
    x3 = torch.zeros(2, 3840, 128, device=cuda)
    n, cap = mr.reduce_config(3840, lambda n, c: mr.reduce_occupancy(n, c)[0])
    assert (n, cap) == (16, mr.K1_STAGE_TILES)
    assert mr.reduce_occupancy(n, cap)[1] >= 3
    with pytest.raises(RuntimeError, match="mr_reduce launch failed"):
        mr._reduce(x3, 0.2, 3840 * 128 - 5, 17, cap)
    with pytest.raises(RuntimeError, match="mr_reduce launch failed"):
        mr._reduce(x3, 0.2, 3840 * 128 - 5, 16, 0)


@pytest.mark.parametrize("d", [3610, 65500])
@pytest.mark.parametrize("G", [1, 40])
def test_sign_kernels_equal_plain_versions(cuda, d, G):
    x = deltas(d + G, max(G, 2), d, cuda)[:G]
    x[0, :6] = torch.tensor([0.0, -0.0, float("nan"), 1.4e-45, -1.4e-45,
                             float("inf")])
    rows = ops.wire_view(x).reshape(-1, 128).contiguous()
    reset_launch_counts()
    words = qp.signpack(rows)
    assert bits_equal(words, ref.signpack_ref(rows))
    # x > 0 is IEEE on the card: a positive subnormal packs as 1
    assert int(words[0, 0]) & 0x3F == 0b101000
    w3 = words.reshape(G, -1, 4)
    scales = torch.rand(G, device=cuda) * 2 - 0.5
    got = qp.sign_dequant_reduce(w3, scales)
    assert bits_equal(got, ref.sign_dequant_reduce_ref(w3, scales))
    torch.cuda.synchronize()
    assert LAUNCHES["signpack"] == 1 and LAUNCHES["sign_dequant_reduce"] == 1


def random_words(G, W, seed, device):
    """[G, W, 4] uint32 sign words, every bit pattern equally likely."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (G, W, 4), generator=g,
                         dtype=torch.int64, device=device) \
        .to(torch.int32).view(torch.uint32)


@pytest.mark.parametrize("W", [1, 29, 3840])
@pytest.mark.parametrize("G", [1, 2, 3, 40, 41, 257, 1000])
def test_k5_equals_plain_version(cuda, G, W):
    """K5 at peer counts below, at and past a stage of 32, across its
    blocks' rows (W = 1, 29 ragged, 3840 the main shape), bit for bit."""
    words = random_words(G, W, G * W, cuda)
    scales = torch.rand(G, generator=torch.Generator(device=cuda)
                        .manual_seed(G), device=cuda) * 2 - 0.5
    reset_launch_counts()
    got = qp.sign_dequant_reduce(words, scales)
    assert bits_equal(got, ref.sign_dequant_reduce_ref(words, scales))
    torch.cuda.synchronize()
    assert LAUNCHES["sign_dequant_reduce"] == 1


K5_SPECIAL_SCALES = (0.0, -0.0, 1.4e-45, -1e-39, float("inf"),
                     -float("inf"), float("nan"), 0.75)


@pytest.mark.parametrize("G", [1, 2, 3, 40])
def test_k5_special_scales_equal_plain_version(cuda, G):
    """Scales of 0.0, -0.0, subnormals, +-inf and NaN, bit for bit: at
    G = 1 each alone (a scale of 0.0 gives -0.0 where the bit is clear),
    past it every rotation of them over the peers."""
    W = 29
    words = random_words(G, W, 7 + G, cuda)
    special = torch.tensor(K5_SPECIAL_SCALES, device=cuda)
    n = len(K5_SPECIAL_SCALES)
    for j in range(n):
        scales = special[(torch.arange(G, device=cuda) + j) % n]
        got = qp.sign_dequant_reduce(words, scales)
        assert bits_equal(got, ref.sign_dequant_reduce_ref(words, scales))
        if G == 1 and j == 0:                   # a scale of +0.0
            bits = ref._unpack(words[0], 1).reshape(W, 128) > 0
            assert torch.equal(torch.signbit(got), ~bits)
            assert bool((got == 0.0).all())


def test_k5_replay_from_a_cuda_graph(cuda):
    """K5 at the main shape (G = 40, W = 3840) captured once in a CUDA
    graph and replayed on new words and scales copied in place: each
    replay equals the plain version bit for bit."""
    G, W = 40, 3840
    words = random_words(G, W, 1, cuda)
    scales = torch.rand(G, device=cuda) - 0.5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qp.sign_dequant_reduce(words, scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qp.sign_dequant_reduce(words, scales)
    for seed in (2, 3):
        words.copy_(random_words(G, W, seed, cuda))
        scales.copy_(torch.rand(G, device=cuda) * 4 - 2)
        graph.replay()
        torch.cuda.synchronize()
        assert bits_equal(out, ref.sign_dequant_reduce_ref(words, scales))


def test_k5_refuses_misaligned_words_and_other_plans(cuda):
    words = random_words(3, 9, 0, cuda)
    scales = torch.ones(3, device=cuda)
    flat = torch.empty(3 * 9 * 4 + 1, dtype=torch.uint32, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        qp.sign_dequant_reduce(flat[1:].view(3, 9, 4), scales)
    with pytest.raises(RuntimeError, match="qp_sign_dequant_reduce launch "
                                           "failed"):
        qp._l.launch(qp._library(), "qp_sign_dequant_reduce",
                     words.data_ptr(), scales.data_ptr(),
                     torch.empty(9, 128, device=cuda).data_ptr(), 3, 9,
                     qp.K5_ROWS // 2, qp.K5_LANES, 2, qp._l.stream())


def test_k1_k2_past_one_launch_of_users(cuda):
    """U = 65,536 users at d = 3610 (W = 29): K1 and K2 launch two chunks
    of users each and equal their plain versions bit for bit, as does
    the kernel encode (K1, epilogue, K2); no ValueError."""
    U, d, lam, b = 65536, 3610, 0.2, 10
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((U, d), generator=g, device=cuda)
    x[:, :40] *= 50.0
    x[1] = 0.0
    x3 = ops.wire_view(x).contiguous()
    reset_launch_counts()
    head = mr.mixed_res_reduce(x3, lam, d)
    assert bits_equal(head, ref.mixed_res_reduce_ref(x3, lam, d))
    wire = ops.mixed_res_encode(x, lam, b, path=WirePath(lowering="kernel"))
    plain = ops.mixed_res_encode(x, lam, b,
                                 path=WirePath(lowering="reference"))
    for k, p in zip(wire, plain):
        assert bits_equal(k, p)
    del plain
    got = mr.mixed_res_emit(x3, wire.head, b, d, anchored=True)
    want = ref.mixed_res_emit_ref(x3, wire.head, b, d, anchored=True)
    for k, p in zip(got, want):
        assert bits_equal(k, p)
    torch.cuda.synchronize()
    assert LAUNCHES["mixed_res_reduce"] == 4
    assert LAUNCHES["mixed_res_emit"] == 4


def test_kernel_wrappers_check_inputs(cuda):
    x3 = torch.zeros(2, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        mr.mixed_res_reduce(x3.double(), 0.2, 512)
    with pytest.raises(ValueError, match="contiguous"):
        mr.mixed_res_emit(x3, torch.zeros(8, 2, device=cuda).t(), 10, 512)
    with pytest.raises(ValueError, match="is on"):
        mr.mixed_res_emit(x3, torch.zeros(2, 8), 10, 512)


def test_engine_round_on_card_matches_cpu(cuda):
    """Two narrow rounds on the card and on the CPU from identical
    params and minibatches: the local deltas within 1e-3 of their
    largest element (cuDNN vs the CPU, magnified by AdaGrad), and the
    wire path — K1–K3 on the card, the plain versions on the CPU — bit
    for bit on the same deltas."""
    scn = dataclasses.replace(
        get_scenario("paper-table3"), aggregation="wire", K=4, T=2,
        n_train=160, n_test=40, batch_size=8, L=2, M=4, N=2, eval_every=1)
    q = MixedResolutionQuantizer(0.2, 10)
    from repro_torch.configs.paper_cnn import PaperCNNConfig
    from repro_torch.fl.cnn import init_cnn
    init = init_cnn(torch.Generator().manual_seed(0), PaperCNNConfig())
    make = lambda dev: make_engine(scn, q, "bisection-lp", device=dev,
                                   init_params=init)
    reset_launch_counts()
    for train_err, card, cpu in card_vs_cpu_rounds(make, scn.T):
        assert train_err <= 1e-3, train_err
        for a, c in zip(card[0], cpu[0]):
            assert bits_equal(a, c)
        assert bits_equal(card[2], cpu[2])
        assert bits_equal(card[1], cpu[1])
    assert LAUNCHES == {"mixed_res_reduce": 4, "mixed_res_emit": 4,
                        "mixed_res_dequant_reduce": 2, "signpack": 0,
                        "sign_dequant_reduce": 0, "flash_decode": 0}


@pytest.mark.parametrize("plane", ["signplane", "dense"])
def test_plane_round_on_card_matches_cpu(cuda, plane):
    """Two narrow signplane or dense rounds on the card and on the CPU
    from identical params and minibatches: the deltas within 1e-3 of
    their largest element; on the same deltas the batched recons, bits,
    sign words (K4) and sign-plane sum (K5) bit for bit, the aggregate
    within 4 * G * eps32 * sum_g w_g * ||x_g||_inf (its weighted sum
    runs in cuBLAS on the card)."""
    scn = dataclasses.replace(
        get_scenario("paper-table3"), aggregation=plane, K=4, T=2,
        n_train=160, n_test=40, batch_size=8, L=2, M=4, N=2, eval_every=1)
    q = MixedResolutionQuantizer(0.2, 10)
    from repro_torch.configs.paper_cnn import PaperCNNConfig
    from repro_torch.fl.cnn import init_cnn
    init = init_cnn(torch.Generator().manual_seed(0), PaperCNNConfig())
    make = lambda dev: make_engine(scn, q, "bisection-lp", device=dev,
                                   init_params=init)
    w = make("cpu")._weights
    reset_launch_counts()
    for train_err, card, cpu in card_vs_cpu_rounds(make, scn.T):
        assert train_err <= 1e-3, train_err
        for a, c in zip(card[0], cpu[0]):
            assert bits_equal(a, c)
        assert bits_equal(card[2], cpu[2])
        tol = agg_tol(w, card[3])
        assert float((card[1].cpu() - cpu[1]).abs().max()) <= tol
    # per round: the engine's aggregate (one K4, one K5) and the
    # comparison's signpack_op and packed_sign_weighted_sum
    sign = plane == "signplane"
    assert LAUNCHES == {"mixed_res_reduce": 0, "mixed_res_emit": 0,
                        "mixed_res_dequant_reduce": 0,
                        "signpack": 6 if sign else 0,
                        "sign_dequant_reduce": 4 if sign else 0,
                        "flash_decode": 0}


# ------------------------------------------------- the paper's baselines
BASELINES = {"classic": ("classic", {}), "top-q": ("top-q", {"q": 0.01}),
             "laq": ("laq", {"b": 4, "xi": 0.5}),
             "aquila": ("aquila", {"b_min": 2, "b_max": 8, "tol": 0.05})}


@pytest.mark.parametrize("qlabel", list(BASELINES))
def test_baseline_quantizer_on_card_matches_cpu(cuda, qlabel):
    """``batched`` on the card against the CPU (``baseline_card_vs_cpu``):
    classic and top-q bit for bit; AQUILA's b the same away from tol and
    bit for bit where it agrees; LAQ over three calls on drifting deltas,
    bit for bit where the skip decisions agree (they differ only on the
    threshold)."""
    name, kw = BASELINES[qlabel]
    if name == "laq":            # Gaussian rows drifting by 2% a call
        g = torch.Generator(device=cuda).manual_seed(1)
        base = torch.randn((8, 65500), generator=g, device=cuda)
        flats = [base + 0.02 * i * torch.randn(base.shape, generator=g,
                                               device=cuda)
                 for i in range(3)]
    else:
        flats = [deltas(0, 8, 65500, cuda)]
    found = baseline_card_vs_cpu(lambda: make_quantizer(name, **kw), flats)
    assert found["flips"] == 0
    if name == "laq":
        assert found["skips"] > 0 and found["energy_rel"] <= 1e-6


@pytest.mark.parametrize("qlabel", list(BASELINES) + ["dinkelbach",
                                                      "max-sum-rate"])
def test_baseline_rounds_on_card(cuda, qlabel):
    """Two full-width rounds of a tiny paper-table3 on the card's dense
    plane for each baseline (bisection-LP), and for mixed-resolution under
    each benchmark power controller: each user's bits follow the
    quantizer's payload rule, LAQ's state lives on the card, no wire
    kernel launches and every param stays finite."""
    scn = dataclasses.replace(
        get_scenario("paper-table3"), K=4, T=2, n_train=160, n_test=40,
        batch_size=8, L=1, M=4, N=2, eval_every=1)
    if qlabel in BASELINES:
        q, pc = BASELINES[qlabel], "bisection-lp"
    else:
        q, pc = ("mixed-resolution", {"lambda_": 0.4, "b": 4}), qlabel
    eng = make_engine(scn, q, pc, device=cuda)
    reset_launch_counts()
    res = eng.run()
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES
    rule, ok = payload_rule(q[0], eng.d)
    for log in res.logs:
        assert np.all(ok(log.bits_per_user)), (rule, log.bits_per_user)
        assert np.isfinite(log.cum_latency_s) and log.cum_latency_s > 0
    if qlabel == "laq":
        assert eng.qstate.last_sent.device.type == "cuda"
    for v in res.params.values():
        assert bool(torch.isfinite(v).all())


# ----------------------------------------------- exact mode and churn
def tiny_table3(**kw):
    base = dict(K=4, T=2, n_train=160, n_test=40, batch_size=8, L=2, M=4,
                N=2, eval_every=1)
    base.update(kw)
    return dataclasses.replace(get_scenario("paper-table3"), **base)


def test_exact_mode_matches_sequential_on_card(cuda):
    """Two rounds of a tiny paper-table3 (K=4, the paper CNN at full
    width) in the engine's exact mode against ``run_fl_sequential`` on
    the card from one init: params, bits, latency, mean s and accuracy
    bit for bit."""
    from repro_torch.configs.paper_cnn import PaperCNNConfig
    from repro_torch.core.power import BisectionLPPowerControl
    from repro_torch.fl.cnn import init_cnn
    from repro_torch.fl.loop import FLConfig, run_fl, run_fl_sequential
    from repro_torch.sim.scenarios import build_problem

    scn = tiny_table3()
    train, test, shards, cfg, chan = build_problem(scn)
    init = init_cnn(torch.Generator().manual_seed(0), PaperCNNConfig())
    fl = FLConfig(L=scn.L, T=scn.T, batch_size=scn.batch_size,
                  alpha=scn.lr, eval_every=1, seed=0)
    runs = [f(train, test, shards, cfg, MixedResolutionQuantizer(0.2, 10),
              BisectionLPPowerControl(), chan, fl, device=cuda,
              init_params=init) for f in (run_fl_sequential, run_fl)]
    assert run_mismatches(runs[1], runs[0]) == []
    assert runs[1].params["conv_w"].device.type == cuda.type


def test_exact_fold_on_card_equals_cpu(cuda):
    """The exact mode's fold of 40 full-width reconstructions on the
    card, bit for bit the same fold on the CPU (one IEEE rounding a
    product and a sum on both), zero weights included."""
    from repro_torch.sim.engine import ordered_weighted_sum

    recon = deltas(3, 40, 462410, cuda)
    w = torch.rand(40, generator=torch.Generator().manual_seed(0))
    w[::7] = 0.0
    w = w / w.sum()
    got = ordered_weighted_sum(recon, w.to(cuda))
    assert bits_equal(got, ordered_weighted_sum(recon.cpu(), w))


@pytest.mark.parametrize("absent", [(0,), (1, 3), (0, 1, 2)])
def test_k3_k5_zero_weights_equal_plain_versions(cuda, absent):
    """K3 with absent users' weights 0 and K5 with their scales 0 (as a
    churn round hands them over), bit for bit their plain versions."""
    U, d, b = 4, 65500, 10
    x = deltas(11, U, d, cuda)
    wire = ops.mixed_res_encode(x, 0.2, b, path=WirePath(lowering="kernel"))
    w = torch.tensor([0.1, 0.2, 0.3, 0.4], device=cuda)
    w[list(absent)] = 0.0
    got = mr.mixed_res_dequant_reduce(*wire[:4], w, b)
    assert bits_equal(got, ref.mixed_res_dequant_reduce_ref(*wire[:4], w, b))
    rows = ops.wire_view(x).reshape(-1, 128).contiguous()
    words = qp.signpack(rows).reshape(U, -1, 4)
    scales = w * wire.head[:, 1] * 0.5
    got = qp.sign_dequant_reduce(words, scales)
    assert bits_equal(got, ref.sign_dequant_reduce_ref(words, scales))


@pytest.mark.parametrize("plane", ["packed", "signplane", "laq"])
def test_churn_rounds_on_card(cuda, plane):
    """Three rounds of a tiny churn-0.7 (K=6) on each plane on the card
    (``churn_rounds``): each K3 or K5 launch bit for bit its plain
    version on the same inputs with absent users' weights or scales 0;
    LAQ's absent users' state unchanged; absent users' bits and
    latencies 0; the launches one K1, K2, K3 or K4, K5 a round."""
    agg = {"packed": "wire", "laq": "dense"}.get(plane, plane)
    scn = dataclasses.replace(get_scenario("churn-0.7"), aggregation=agg,
                              K=6, T=3, n_train=240, n_test=40,
                              batch_size=8, L=1, M=4, N=2, eval_every=1)
    q = ("laq", {"b": 4, "xi": 0.5}) if plane == "laq" \
        else ("mixed-resolution", {"lambda_": 0.2, "b": 10})
    eng = make_engine(scn, q, "bisection-lp", device=cuda)
    reset_launch_counts()
    absent = 0
    for work, log, info in churn_rounds(eng, scn.T):
        absent += eng.K - info["active"]
        assert 1 <= info["active"] <= eng.K
        assert log.effective_participation == info["active"] / eng.K
    assert absent > 0
    torch.cuda.synchronize()
    want = {"packed": ("mixed_res_reduce", "mixed_res_emit",
                       "mixed_res_dequant_reduce"),
            "signplane": ("signpack", "sign_dequant_reduce"),
            "laq": ()}[plane]
    assert LAUNCHES == {k: scn.T if k in want else 0 for k in LAUNCHES}


# ------------------------------------------------------- batched phy
@pytest.mark.parametrize("name", ["bisection-lp", "dinkelbach",
                                  "max-sum-rate"])
def test_phy_solvers_card_equal_cpu_float64(cuda, name):
    """The float64 (forward-difference) batched solve on the card against
    the same solve on the CPU, 16 realizations at K=10: rates within the
    x64 contract's 1e-5 (max-sum over 5 iterations, before the ascent
    bifurcates); every p in [0, 1]."""
    from repro_torch import phy
    from repro_torch.core.channel import CFmMIMOConfig, make_channel
    from repro_torch.core.power import make_power_controller

    chans = [make_channel(CFmMIMOConfig(K=10, M=9), seed=s)
             for s in range(16)]
    bits = np.random.default_rng(1).uniform(1e5, 2e6, (16, 10))
    mask = (np.random.default_rng(2).random((16, 10)) < 0.7).astype(float)
    mask[:, 0] = 1.0
    kw = {"iters": 5} if name == "max-sum-rate" else {}
    solve = phy.batched_solver(make_power_controller(name, **kw))
    got, want = (solve(phy.bundle_from_realizations(
        chans, dtype=torch.float64, device=dev), bits, mask=mask)
        for dev in (cuda, "cpu"))
    assert got.p.is_cuda
    p = got.p.cpu().numpy()
    assert np.all((p >= 0.0) & (p <= 1.0)) and np.all(p[mask == 0] == 0.0)
    r, w = got.rates.cpu().numpy(), want.rates.numpy()
    assert np.max(np.abs(r - w) / np.maximum(np.abs(w), 1.0)) < 1e-5


@pytest.mark.parametrize("plane", ["packed", "signplane"])
def test_replicated_wire_steps_equal_plain_versions(cuda, plane):
    """R = 2 replicates of a tiny churn-0.7 (K=6) on the packed or the
    signplane plane, one replicate at a time: K1-K3 or K4-K5 launch
    R x rounds times, each launch bit for bit its plain version on the
    same inputs; replicate 0 is the unreplicated run bit for bit."""
    from repro_torch.fl.loop import deterministic_cudnn

    scn = dataclasses.replace(get_scenario("churn-0.7"),
                              aggregation={"packed": "wire"}.get(plane, plane),
                              K=6, T=2, n_train=240, n_test=40,
                              batch_size=8, L=1, M=4, N=2, eval_every=1)
    eng = make_engine(scn, ("mixed-resolution", {"lambda_": 0.2, "b": 10}),
                      "bisection-lp", device=cuda)
    kernels = {"packed": ("mixed_res_reduce", "mixed_res_emit",
                          "mixed_res_dequant_reduce"),
               "signplane": ("signpack", "sign_dequant_reduce")}[plane]
    with deterministic_cudnn():
        st = eng.start_replicated_run(2)
        reset_launch_counts()
        with WireSpy() as spy:
            works = [eng.train_round_replicated(st, t) for t in (1, 2)]
        torch.cuda.synchronize()
        assert LAUNCHES == {k: 4 if k in kernels else 0 for k in LAUNCHES}
        # the churn masks differ by replicate; check() holds the weights
        # and scales of users absent in every recorded call only
        absent = np.all([w.active == 0 for w in works], axis=(0, 1))
        assert spy.check(absent) == {k: 4 for k in kernels}
        un = eng.start_run()
        uworks = [eng.train_round(un, t) for t in (1, 2)]
    for w, u in zip(works, uworks):
        np.testing.assert_array_equal(w.bits_np[0], u.bits_np)
        np.testing.assert_array_equal(w.active[0], u.active)
    for k in un.params:
        assert same_bits(st.params[k][0], un.params[k]), k


def test_replicate_vmap_matches_map_on_card(cuda):
    """The dense plane's replicate vmap (``"auto"`` on the card) against
    the loop over replicates: bits exact after a round, params within
    1e-3 of the largest move (two conv lowerings, their roundoff
    magnified by AdaGrad, as ``test_engine_round_on_card_matches_cpu``
    bounds the card against the CPU)."""
    scn = dataclasses.replace(get_scenario("monte-carlo-replicated"), K=6,
                              T=1, n_train=240, n_test=40, batch_size=8, L=1,
                              M=4, N=2)
    out = {}
    for mode in ("auto", "map"):
        eng = make_engine(scn, ("mixed-resolution", {"lambda_": 0.2, "b": 10}),
                          "bisection-lp", device=cuda)
        eng.engine_cfg = dataclasses.replace(eng.engine_cfg,
                                             replicate_batching=mode)
        assert eng._replicated_step(3).__name__ == \
            {"auto": "step_vmap", "map": "step_map"}[mode]
        st = eng.start_replicated_run(3)
        w = eng.train_round_replicated(st, 1)
        out[mode] = (w.bits_np, st.params, eng.params)
    np.testing.assert_array_equal(out["auto"][0], out["map"][0])
    for k, init in out["map"][2].items():
        move = float((out["map"][1][k] - init).abs().max())
        diff = float((out["map"][1][k] - out["auto"][1][k]).abs().max())
        assert diff <= 1e-3 * move, (k, diff, move)


# ----------------------- cohorts, clusters, budgets and async rounds
def tiny_wire(name, **kw):
    base = dict(K=7, T=2, n_train=280, n_test=40, batch_size=8, L=1,
                eval_every=1)
    base.update(kw)
    return dataclasses.replace(get_scenario(name), **base)


WIRE = ("mixed_res_reduce", "mixed_res_emit", "mixed_res_dequant_reduce")
MIXED = ("mixed-resolution", {"lambda_": 0.2, "b": 10})


@pytest.mark.parametrize("C", [3, 7])
def test_cohort_rounds_on_card(cuda, C):
    """Two rounds of a tiny cohort-wire (K=7, the paper CNN at full
    width) on the card: K1, K2 and K3 launch once a cohort (C=3: 3, 3
    and 1 user padded to 3), each launch bit for bit its plain version
    (``WireSpy``); C=7 is the vectorized step bit for bit (inside
    ``deterministic_cudnn``)."""
    from repro_torch.fl.loop import deterministic_cudnn

    scn = tiny_wire("cohort-wire", cohort_size=C)
    n = -(-scn.K // C)
    with deterministic_cudnn():
        eng = make_engine(scn, MIXED, None, device=cuda)
        reset_launch_counts()
        with WireSpy() as spy:
            res = eng.run()
        torch.cuda.synchronize()
        assert LAUNCHES == {k: scn.T * n if k in WIRE else 0
                            for k in LAUNCHES}
        assert spy.check(np.zeros(min(C, scn.K))) \
            == {k: scn.T * n for k in WIRE}
        vec = make_engine(dataclasses.replace(scn, cohort_size=None), MIXED,
                          None, device=cuda).run()
    if C >= scn.K:
        assert run_mismatches(res, vec) == []
    for v in res.params.values():
        assert bool(torch.isfinite(v).all())


@pytest.mark.parametrize("C", [1, 4, 13])
def test_cohort_fold_on_card(cuda, C):
    """The fold on the card on given deltas (U=13, d=65500): chunks of C
    encoded and folded through K3's ``acc`` equal the one-shot K3 as
    values, with the same headers; user 2 at weight 0."""
    from _torch_parity import fold_chunks

    U, d, b = 13, 65500, 10
    x = deltas(21, U, d, cuda)
    w = torch.rand(U, generator=torch.Generator().manual_seed(C)).to(cuda)
    w[2] = 0.0
    wire = ops.mixed_res_encode(x, 0.2, b)
    one = ops.mixed_res_wire_reduce(wire, w, b, d)
    acc, head = fold_chunks(x, w, 0.2, b, C)
    assert torch.equal(acc, one) and bits_equal(head, wire.head)


def test_cohort_hierarchy_on_card(cuda):
    """A tiny cohort-hierarchy (K=7, C=3, 2 clusters) against the flat
    cohort step from the same init: bits bit for bit, params within
    1e-4; clusters of 4 and 3 users, 2 + 1 cohorts, 3 launches a
    round."""
    from _torch_parity import params_gap
    from repro_torch.fl.loop import deterministic_cudnn

    scn = tiny_wire("cohort-hierarchy", cohort_size=3, clusters=2)
    with deterministic_cudnn():
        reset_launch_counts()
        hier = make_engine(scn, MIXED, None, device=cuda).run()
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        flat = make_engine(dataclasses.replace(scn, clusters=1), MIXED, None,
                           device=cuda).run()
    assert launched == {k: 3 * scn.T if k in WIRE else 0
                        for k in launched}
    for a, b in zip(hier.logs, flat.logs, strict=True):
        np.testing.assert_array_equal(a.bits_per_user, b.bits_per_user)
    assert params_gap(hier.params, flat.params) <= 1e-4


def test_cohort_peak_tracks_c_on_card(cuda):
    """One sample a user at K=600 (the paper CNN): a cohort round (C=64)
    holds far less above its start than the vectorized round, and no
    tensor of the round holds K with d."""
    from benchmarks.torch_cohort_scale import LargestD

    peaks = {}
    for C in (64, None):
        scn = tiny_wire("cohort-wire", K=600, n_train=600, batch_size=1,
                        cohort_size=C)
        eng = make_engine(scn, MIXED, None, device=cuda)
        state = eng.start_run()
        eng.train_round(state, 1)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with LargestD(eng.d) as probe:
            eng.train_round(state, 2)
        torch.cuda.synchronize()
        peaks[C] = torch.cuda.max_memory_allocated() - held
        if C is not None:
            assert 600 not in probe.shape and probe.shape[0] <= C
    assert peaks[64] < peaks[None] / 3, peaks


def test_layer_budget_on_card(cuda):
    """layer-budget-wire's segments of the paper CNN: K1-K3 bit for bit
    their plain versions at U=5 and each segment's shape, lambda and b
    (K2 on both rules, K3 with and without acc); two rounds of a tiny
    layer-budget-wire, 6 launches of each a round, every launch bit for
    bit its plain version; a uniform budget bit for bit the global
    path."""
    from repro_torch.core.quantize import LayerBudget
    from repro_torch.fl.loop import deterministic_cudnn

    scn = tiny_wire("layer-budget-wire")
    eng = make_engine(scn, MIXED, None, device=cuda)
    segs = eng._segments
    assert [s.size for s in segs] == [32, 864, 64, 460800, 10, 640]
    for seg in segs:
        x = deltas(seg.size, 5, seg.size, cuda)
        k1_k2_exact(x, seg.lambda_, seg.b)
        wire = ops.mixed_res_encode(x, seg.lambda_, seg.b)
        w = torch.tensor([0.1, 0.2, 0.3, 0.0, 0.4], device=cuda)
        rows = ops.sign_pad_len(seg.size) // 128
        for acc in (None, torch.randn(rows, 128, device=cuda)):
            assert bits_equal(
                mr.mixed_res_dequant_reduce(*wire, w, seg.b, acc=acc),
                ref.mixed_res_dequant_reduce_ref(*wire, w, seg.b, acc=acc))
    with deterministic_cudnn():
        reset_launch_counts()
        with WireSpy() as spy:
            eng.run()
        torch.cuda.synchronize()
        assert LAUNCHES == {k: 6 * scn.T if k in WIRE else 0
                            for k in LAUNCHES}
        assert spy.check(np.zeros(scn.K)) == {k: 6 * scn.T for k in WIRE}
        runs = [make_engine(dataclasses.replace(
            get_scenario("fused-wire"), K=7, T=2, n_train=280, n_test=40,
            batch_size=8, L=1, eval_every=1, budget=budget), MIXED, None,
            device=cuda).run() for budget in (None, LayerBudget.uniform())]
    assert run_mismatches(runs[1], runs[0]) == []


@pytest.mark.parametrize("aggregation", ["dense", "wire"])
def test_async_rounds_on_card(cuda, aggregation):
    """Three rounds of a tiny async-q50 (K=6) on the card: on the packed
    plane K1 and K2 once a round and K3 once over 2K slots, each launch
    bit for bit its plain version; uploads conserved; the sync reduction
    bit for bit the lockstep run (inside ``deterministic_cudnn``)."""
    from repro_torch.fl.loop import deterministic_cudnn
    from repro_torch.sim import run_cell

    scn = tiny_wire("async-q50", K=6, T=3, n_train=240,
                    aggregation=aggregation, M=4, N=2)
    eng = make_engine(scn, MIXED, "bisection-lp", device=cuda)
    state = eng.start_run()
    reset_launch_counts()
    with WireSpy() as spy:
        for t in range(1, scn.T + 1):
            work = eng.train_round(state, t)
            up, pu = eng.solve_uplink_host(state.chan, work.bits_np,
                                           work.active)
            info = eng.complete_round_async(state, work, pu)
            eng.finish_round(state, work, up, async_info=info, per_user_s=pu)
    torch.cuda.synchronize()
    n = scn.T if aggregation == "wire" else 0
    assert LAUNCHES == {k: n if k in WIRE else 0 for k in LAUNCHES}
    assert spy.check(np.zeros(2 * scn.K)) == ({k: n for k in WIRE} if n
                                              else {})
    c = state.async_clock
    assert c.uploads_started == (c.arrived_total + c.dropped_stale
                                 + c.dropped_churn + int(c.in_flight.sum()))
    sync = dataclasses.replace(scn, deadline_quantile=None)
    with deterministic_cudnn():
        a, b = (run_cell(s, MIXED, "bisection-lp", quick=False, device=cuda)
                for s in (sync, dataclasses.replace(sync, async_mode=False)))
    assert run_mismatches(a.result, b.result) == []


def test_async_packed_replicates_on_card(cuda):
    """async-q50-wire (K=6) with R = 2 through ``run_grid_batched`` on
    the card: the replicates loop, K1, K2 and K3 once a replicate a
    round, each launch bit for bit its plain version; the stacked
    buffer stays uint32; replicate 0 is the unreplicated run bit for bit
    (inside ``deterministic_cudnn``) and replicate 1 another run."""
    from repro_torch.fl.loop import deterministic_cudnn
    from repro_torch.sim import run_grid_batched

    scn = tiny_wire("async-q50-wire", K=6, T=3, n_train=240, M=4, N=2)
    grid = lambda R: run_grid_batched([scn], {"mixed": MIXED},
                                      {"bisection-lp": "bisection-lp"},
                                      quick=False, device=cuda,
                                      replicates=R)[0].result
    with deterministic_cudnn():
        reset_launch_counts()
        with WireSpy() as spy:
            rep = grid(2)
        torch.cuda.synchronize()
        assert LAUNCHES == {k: 2 * scn.T if k in WIRE else 0
                            for k in LAUNCHES}
        assert spy.check(np.zeros(2 * scn.K)) == {k: 2 * scn.T
                                                   for k in WIRE}
        one = grid(None)
    assert run_mismatches(rep[0], one) == []
    assert run_mismatches(rep[1], one) != []
    eng = make_engine(scn, MIXED, "bisection-lp", device=cuda)
    st = eng.start_replicated_run(2)
    work = eng.train_round_replicated(st, 1)
    eng.complete_round_replicated_async(
        st, work, np.full((2, scn.K), 1.0) + np.arange(scn.K))
    buf = st.async_clock.buffer
    assert buf.signs.dtype == buf.codes.dtype == torch.uint32
    assert buf.signs.shape[:2] == (2, scn.K)


def test_chip_smoke_user_axis_and_round_mode_phases(cuda):
    """The phases themselves: ``chip_smoke.py``'s cohort, fold,
    hierarchy, scale, budget and async phases at full width, in this
    process after the script's own build (about a minute on the card);
    a failed check raises, and each phase launches K1-K3."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    chip_smoke.build_all()
    launches = {}
    chip_smoke.user_axis_and_round_modes(cuda, launches)
    for k in ("mixed_res_reduce", "mixed_res_emit",
              "mixed_res_dequant_reduce"):
        assert launches[k] > 0, (k, launches)


# ---------------------------------------------------------------- K6
def kv_inputs(seed, B, Hkv, G, S, D, Dv, dtype, device):
    """q [B, Hkv*G, D] and caches [B, S, Hkv, D(v)] from numpy."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.tensor(
        rng.standard_normal(shape).astype(np.float32), device=device
    ).to(dtype)
    return mk(B, Hkv * G, D), mk(B, S, Hkv, D), mk(B, S, Hkv, Dv)


def bf16_bound(want):
    """(atol, rtol) for K6 in bf16 (chip_smoke.K6_TOL): both round the
    same f32 result to bf16, so one bf16 ulp apart at most (<= 2^-7
    |want|), and 2^-8 max |want| for outputs near 0."""
    return 2.0 ** -8 * float(want.abs().max()), 1e-2


@pytest.mark.parametrize("B,Hkv,G,S,D,Dv,dtype,length", [
    (1, 1, 1, 512, 64, 64, torch.float32, 495),
    (2, 4, 2, 1024, 128, 128, torch.float32, 1007),
    (2, 2, 8, 2048, 64, 64, torch.bfloat16, 2031),
    (1, 8, 5, 512, 128, 64, torch.float32, 495),     # uneven group, Dv != D
    (8, 8, 4, 4096, 128, 128, torch.bfloat16, 4096),  # the serve shape
    (3, 2, 4, 1000, 128, 128, torch.float32, 1),      # S % 512 != 0
    (3, 2, 4, 1000, 128, 128, torch.bfloat16, 3),
    (2, 8, 5, 777, 128, 128, torch.bfloat16, 777),
])
def test_flash_decode_equals_plain_version(cuda, B, Hkv, G, S, D, Dv,
                                           dtype, length):
    """K6 through ``flash_decode_op`` on the cache layout, length on the
    device, against the plain version on the same CUDA inputs."""
    q, k, v = kv_inputs(S + G, B, Hkv, G, S, D, Dv, dtype, cuda)
    n = torch.tensor(length, dtype=torch.int32, device=cuda)
    reset_launch_counts()
    got = ops.flash_decode_op(q, k, v, n)
    want = ref.flash_decode_ref(q.reshape(B, Hkv, G, D), k.transpose(1, 2),
                                v.transpose(1, 2), length)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_decode"] == 1
    want = want.reshape(B, Hkv * G, Dv).float()
    if dtype == torch.bfloat16:
        atol, rtol = bf16_bound(want)
    else:
        atol = rtol = 1e-5
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def test_flash_decode_graph_replays_at_any_length(cuda):
    """K6 at the serve shape captured once in a CUDA graph, replayed after
    the device ``length`` is set in place to 1, 3, 4079 and 4096: the
    split is sized on the card, so each replay equals the plain version
    within one bf16 ulp."""
    B, Hkv, G, S, D = 8, 8, 4, 4096, 128
    q, k, v = kv_inputs(5, B, Hkv, G, S, D, D, torch.bfloat16, cuda)
    n = torch.tensor(S, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.flash_decode_op(q, k, v, n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.flash_decode_op(q, k, v, n)
    for length in (1, 3, 4079, 4096):
        n.fill_(length)
        graph.replay()
        want = ref.flash_decode_ref(q.reshape(B, Hkv, G, D),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    length).reshape(B, Hkv * G, D).float()
        atol, rtol = bf16_bound(want)
        torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol)


def test_flash_decode_is_deterministic(cuda):
    """Two K6 calls at the serve shape give the same bits: the splits
    merge in a fixed order."""
    q, k, v = kv_inputs(6, 8, 8, 4, 4096, 128, 128, torch.bfloat16, cuda)
    n = torch.tensor(4096, dtype=torch.int32, device=cuda)
    first = ops.flash_decode_op(q, k, v, n)
    second = ops.flash_decode_op(q, k, v, n)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_flash_decode_checks_inputs(cuda):
    q, k, v = kv_inputs(0, 1, 2, 2, 64, 64, 64, torch.float32, cuda)
    qg, kt, vt = q.reshape(1, 2, 2, 64), k.transpose(1, 2), v.transpose(1, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fd.flash_decode(qg.half(), kt.half(), vt.half(), 5)
    with pytest.raises(ValueError, match="dtype"):
        fd.flash_decode(qg, kt.bfloat16(), vt, 5)
    with pytest.raises(ValueError, match="Dv in"):
        fd.flash_decode(qg, kt, vt[..., :32], 5)
    with pytest.raises(ValueError, match="is on"):
        fd.flash_decode(qg, kt, vt, torch.tensor(5, dtype=torch.int32))


def test_decode_on_card_matches_cpu(cuda):
    """Reduced granite (2 layers, G=2) at f32: prefill + decode on the
    card through K6 against the CPU's plain path from the same params,
    logits within 1e-4 of their largest; one K6 launch per layer and
    step."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_model
    from repro_torch.models.layers import tree_map
    cfg = dc.replace(get_config("granite-3-8b").reduced(), num_kv_heads=2,
                     dtype="float32")
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    caches = {d: init_cache(cfg, 2, 40, cfg.dtype, device=d)
              for d in ("cpu", cuda)}
    reset_launch_counts()
    for t in range(tokens.shape[1]):
        outs = []
        for dev, p in (("cpu", params), (cuda, card)):
            idx = torch.tensor(t, dtype=torch.int32, device=dev)
            lg, caches[dev] = decode_step(p, caches[dev],
                                          tokens[:, t:t + 1].to(dev), idx,
                                          cfg)
            outs.append(lg.cpu())
        scale = float(outs[0].abs().max())
        assert float((outs[1] - outs[0]).abs().max()) <= 1e-4 * scale
    assert LAUNCHES["flash_decode"] == cfg.num_layers * tokens.shape[1]

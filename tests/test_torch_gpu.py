"""The CUDA kernels K1–K5 and the port's engine on an NVIDIA GPU.

Every test here needs the card: the ``cuda`` fixture skips without one,
so the module collects the same tests everywhere.  Run on a machine
with the card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

No jax here: the machine with the card has none.  Each kernel is held
to its plain PyTorch version on the same CUDA inputs — planes, headers,
sign words and the reduces bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import agg_tol, bits_equal, card_vs_cpu_rounds

from repro_torch.core.quantize import MixedResolutionQuantizer
from repro_torch.kernels import LAUNCHES, WirePath, reset_launch_counts
from repro_torch.kernels import mixed_res as mr
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
    assert LAUNCHES == {"mixed_res_reduce": 4, "mixed_res_emit": 1,
                        "mixed_res_dequant_reduce": 2, "signpack": 0,
                        "sign_dequant_reduce": 0}


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
    assert LAUNCHES == {"mixed_res_reduce": 8, "mixed_res_emit": 4,
                        "mixed_res_dequant_reduce": 2, "signpack": 0,
                        "sign_dequant_reduce": 0}


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
                        "sign_dequant_reduce": 4 if sign else 0}

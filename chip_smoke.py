#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and turns TF32 off for convolutions and matmuls;
2. builds the kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   one process per source, all started together (K1–K3 in
   ``mixed_res.cu``, K4–K5 in ``quant_pack.cu``, K6 in
   ``flash_decode.cu``), printing each build's time and ptxas'
   register/spill lines;
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes (K1–K3: U=40 users, W=3840 rows, d=462,410,
   b=10, lambda=0.2; K4–K5: G=40 planes of 3840 rows) and at edge
   shapes — planes, headers, sign words and the reduces bit for bit;
   K1–K3 also at special values (NaN, +-inf, subnormals, -0.0, an
   infinite and a subnormal max) and at d=16,777,000, K2 on both rules;
   K1 and K2 replayed from one CUDA graph; the cutoff search of K1 and
   K2 against its numpy twin; K1 and K2 past one launch of users (U =
   65,536 at d=3610, two launches each); K5 alone at G from 1 to 1000
   and W in {1, 29, 3840}, at scales of 0.0, -0.0, subnormals, +-inf
   and NaN (-0.0 kept at G=1), and replayed from a CUDA graph — and one
   narrow two-round run through the kernels against the same run on the
   CPU's plain path; K6
   (flash-decode attention) at the serve shape (B=8, 8 kv heads, G=4,
   D=128, S=4096) and edge shapes, f32 within 1e-5 and bf16 within one
   bf16 ulp (``K6_TOL``); K6
   captured once in a CUDA graph and replayed at lengths 1, 3, 4079 and
   4096 set in place on the card; two K6 calls bit for bit equal; one
   profiled K6 call running one kernel and nothing else; and a narrow
   reduced granite-3-8b decode through K6 against the same decode on
   the CPU;
4. times each kernel (eager with CUDA events, replayed from a CUDA
   graph, and by the profiler's device time) and its plain version; the
   packed encode as ``mixed_res_encode`` runs it, by device time; and K6
   beside ``scaled_dot_product_attention`` at the serve shape (the same
   three ways; K6 also at length 4) and at ``decode_32k``'s (B=128,
   S=32768, one layer's cache);
5. on one set of full-width deltas from the card, holds the signplane,
   dense and packed aggregates against each other, and the card's
   signplane aggregate against the CPU's;
6. drives the main paths at full width (``paper-table3``: K=40, the
   paper CNN, d=462,410, bisection-LP power control over M=16 APs with
   N=4 antennas), each with the launch counters zeroed just before and
   read just after: 3 rounds on the packed wire plane (K1–K3), 3 on the
   signplane plane (K4–K5), and 1 on the dense plane as registered;
   then a stage breakdown of one packed and one signplane round;
7. the engine's other single-trajectory modes at full width: 2 rounds
   of ``paper-table3`` in the exact mode (users trained one by one
   inside ``deterministic_cudnn``, after two identical per-user calls
   are compared under the default cuDNN flags and inside it), each
   round's wall time and stage split, bit for bit ``run_fl_sequential``
   from the same init; ``churn-0.7`` (K=20) 3 rounds each on the packed
   and signplane planes and on the dense plane with LAQ, the counters
   zeroed before each plane and read after, every K1-K5 launch held
   bit for bit to its plain version on the same inputs (absent users'
   weights and scales 0) and LAQ's absent users' state unchanged; and 3
   rounds of ``monte-carlo-channel``, a channel a round equal to the
   host's ``make_channel`` and an uplink that changes; then the batched
   physical layer: (a) the batched power solvers on 64 realizations of
   ``paper-table3``'s channel against the numpy controllers, float64
   (forward differences) and float32 (autodiff), and their times at
   batch 1 and 64 beside the numpy loop; (b) ``run_grid_batched`` on
   ``paper-table3``'s packed plane x bisection-LP, Dinkelbach and
   max-sum-rate, 3 rounds, one K1, K2, K3 a round for the three cells,
   each round's training and solve seconds, bits equal to the host
   ``run_grid``'s and uplinks within its contract; (c) the replicate
   axis: ``monte-carlo-replicated`` (R=8, vmap) 2 rounds with their
   seconds and peak memory, R = 1 bit for bit the unreplicated run, and
   R = 2 on the packed and signplane planes with every K1-K5 launch
   held to its plain version and replicate 0 the unreplicated run;
   then the user-axis scale and round modes: ``cohort-wire`` (K=20,
   cohorts of 8: K1, K2, K3 three times a round) and C=20 (bit for bit
   ``fused-wire``) beside ``fused-wire``, with the params gap and a
   cohort round's stage split; the fold of the main shape's 40 users in
   chunks of 1, 8, 13 and 40 through K3's ``acc``, equal to the
   one-shot K3; ``cohort-hierarchy`` (bits bit for bit
   ``cohort-wire``'s); one round at K = 2,000 and 20,000 users (one
   sample each, C=256) and the vectorized step at K = 2,000, with
   their wall time and peak memory beside K*d*4 and C*d*4;
   ``layer-budget-wire`` (K1-K3 bit for bit at its six segment shapes
   with and without ``acc``, 6 launches each a round, every launch held
   to its plain version, the bits' segment-sum identity, the device
   time of the six segments' encode and reduce beside one global
   segment's, a uniform budget bit for bit the global path); and async
   rounds (``async-q50`` on the dense and packed planes and
   ``async-churn`` through ``run_cell`` and ``run_grid_batched``, K3
   over 2K = 40 slots bit for bit, ``async-sync-reduction`` bit for bit
   the lockstep run in both drivers);
8. the paper's baselines on the dense plane at full width: on one
   round's deltas (``[40, 462410]``) each of classic, top-q, LAQ (three
   successive calls) and AQUILA on the card against the CPU
   (``tests/_torch_parity.baseline_card_vs_cpu``); 2 rounds each of
   classic, top-q, LAQ and AQUILA under bisection-LP and 2 of
   mixed-resolution(0.4, 4) under Dinkelbach and max-sum-rate, each
   round's wall time, stage split and peak memory printed and each
   user's bits held to the quantizer's payload rule; then the Table III
   script (``benchmarks/torch_table3_latency.py``) in quick mode;
9. serves full-width granite-3-8b (random bf16 weights from a seed, 40
   layers): B=8 prompts of 16 tokens, 48 generated, a 4096-position
   cache, with the launch counters zeroed just before — 40 K6 launches
   a step — printing ms/step, tokens/s and peak memory, and holds
   teacher-forced decode logits against ``forward`` on the same tokens;
   then decodes at a nearly full cache (its first 4064 positions filled
   with random k/v), timing the steps and their device time by kernel,
   and holds one such step's logits through K6 against the same step
   with K6's plain version in its place; then times decode at a short
   context and at the nearly full cache in turns, two of each;
10. prints one ``{"kernels": [...]}`` JSON line (K1–K6; K1–K5's
   launches over the main path's rounds, the churn rounds, the batched
   phy phase's lockstep and R = 2 runs, and the cohort, cluster, scale,
   budget and async rounds), and ends with
   ``{"ok": true, "device": {...}}``.

Exits non-zero, before printing any result, without a CUDA device or
without the repository's sources beside it.  Any failed check raises.
"""
import contextlib
import csv
import dataclasses
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT / "tests"))      # _torch_parity (no jax)

MAIN = dict(U=40, d=462410, b=10, lam=0.2)
ROUNDS = 3
# earlier paths cut to keep the run within PR 17's length: the baselines'
# rounds each, and the decode turns at each length
BASELINE_ROUNDS = 2
DECODE_TURNS = 2
# K1 and K2 past one launch of users (65,535 a launch)
MANY_USERS = 65536
# K5's battery: peer counts below, at and past a stage of 32 peers, row
# counts across its blocks, and the special scales
K5_G = (1, 2, 3, 40, 41, 257, 1000)
K5_W = (1, 29, 3840)
K5_SPECIAL_SCALES = (0.0, -0.0, 1.4e-45, -1e-39, float("inf"),
                     -float("inf"), float("nan"), 0.75)
# the paper's baselines at Table III's settings (benchmarks/
# torch_table3_latency.py), and classic FL from Table II
BASELINES = {"classic": ("classic", {}),
             "top-q": ("top-q", {"q": 0.01}),
             "laq": ("laq", {"b": 4, "xi": 0.5}),
             "aquila": ("aquila", {"b_min": 2, "b_max": 8, "tol": 0.05})}
# the engine's exact mode, churn and redraw phases (rounds each)
EXACT_ROUNDS = 2
CHURN_ROUNDS = 3
CHURN_PLANES = {"packed": ("wire", ("mixed-resolution",
                                    {"lambda_": 0.2, "b": 10})),
                "signplane": ("signplane", ("mixed-resolution",
                                            {"lambda_": 0.2, "b": 10})),
                "dense/laq": ("dense", ("laq", {"b": 4, "xi": 0.5}))}
BASELINE_POWERS = {"dinkelbach": ("dinkelbach", {"outer": 4, "inner": 15}),
                   "max-sum-rate": ("max-sum-rate", {"iters": 20,
                                                     "restarts": 0})}
# the batched phy phase: realizations of paper-table3's channel for the
# solvers, the lockstep grid's power cells and rounds, the replicate rounds
PHY_REALIZATIONS = 64
PHY_POWERS = {"bisection-lp": "bisection-lp",
              "dinkelbach": ("dinkelbach", {"outer": 4, "inner": 15}),
              "max-sum-rate": ("max-sum-rate", {"iters": 20})}
PHY_ROUNDS = 3
REPL_ROUNDS = 2
WIRE_KERNELS = ("mixed_res_reduce", "mixed_res_emit",
                "mixed_res_dequant_reduce")
COHORT_ROUNDS = 3
COHORT_FOLD_CHUNKS = (1, 8, 13, 40)
# (K, C): cohorts of C, None the vectorized step
SCALE_POINTS = ((2000, 256), (20000, 256), (2000, None))
BUDGET_ROUNDS = 3
ASYNC_ROUNDS = 5
SYNC_ROUNDS = 3
# the serve path: granite-3-8b decode, and K6's shape there (one layer)
SERVE = dict(arch="granite-3-8b", B=8, prompt=16, gen=48, max_len=4096)
K6_SERVE = dict(B=8, Hkv=8, G=4, S=4096, D=128, Dv=128)
K6_DECODE_32K = dict(B=128, Hkv=8, G=4, S=32768, D=128, Dv=128)
# K6 against its plain version, elementwise |got - want| <= atol + rtol
# |want|.  f32: the JAX battery's 1e-5.  bf16: both round the same f32
# result to bf16, so they may differ by one bf16 ulp (at most 2^-7 |want|)
# — rtol 1e-2 — and atol 2^-8 max |want| covers outputs near 0.
K6_TOL = {"float32": (lambda want: 1e-5, 1e-5),
          "bfloat16": (lambda want: 2.0 ** -8 * float(want.abs().max()),
                       1e-2)}
# teacher-forced decode logits against forward at full width, bf16:
# within this share of max |logit| (PERF.md)
SERVE_LOGIT_TOL = 5e-2
EPS32 = 2.0 ** -23
# published peaks (NVIDIA data sheets): device memory bytes/s and dense
# f32 (non-tensor-core) operations/s, by the card's name
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}
# dense bf16 tensor-core operations/s (NVIDIA data sheets): K6's bound on
# bf16 inputs counts its operations at this rate
BF16_PEAKS = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100": 989e12}
# operations each kernel does per element, counted from the source (K1:
# abs, divide, compares, min/max, count; K2: the same plus shifts and
# ORs for packing; K3, per user and output element: two products, an
# add, a select, the fold; K4, per input element: the compare and its
# ballot bit; K5, per peer and output element: shift, mask, select, add)
OPS_PER_ELEMENT = {"K1": 8, "K2": 12, "K3": 8, "K4": 2, "K5": 4}
REPLACES = {"K1": "src/repro/kernels/mixed_res.py:122",
            "K2": "src/repro/kernels/mixed_res.py:198",
            "K3": "src/repro/kernels/mixed_res.py:268",
            "K4": "src/repro/kernels/quant_pack.py:36",
            "K5": "src/repro/kernels/quant_pack.py:66",
            "K6": "src/repro/kernels/flash_decode.py:69"}
SOURCES = {"K1": "src/repro_torch/kernels/csrc/mixed_res.cu",
           "K2": "src/repro_torch/kernels/csrc/mixed_res.cu",
           "K3": "src/repro_torch/kernels/csrc/mixed_res.cu",
           "K4": "src/repro_torch/kernels/csrc/quant_pack.cu",
           "K5": "src/repro_torch/kernels/csrc/quant_pack.cu",
           "K6": "src/repro_torch/kernels/csrc/flash_decode.cu"}
NAMES = {"K1": "mixed_res_reduce", "K2": "mixed_res_emit",
         "K3": "mixed_res_dequant_reduce", "K4": "signpack",
         "K5": "sign_dequant_reduce", "K6": "flash_decode"}


T0 = time.perf_counter()


def phase(name):
    print(f"== [{time.perf_counter() - T0:.1f} s] {name}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name, table=PEAKS):
    for key, val in table.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peak rates for {name!r}")


def bitwise_equal(a, b):
    import torch
    a, b = a.contiguous(), b.contiguous()
    if a.dtype != torch.int32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def max_abs_err(a, b):
    """Largest |a - b| over the elements whose bits differ (0.0 when
    none do; an infinite header lane equal in both counts as 0)."""
    import torch
    if a.dtype == torch.float32:
        diff = torch.where(a == b, 0.0, (a - b).abs())
        return float(diff.max())
    return 0.0 if bitwise_equal(a, b) else math.inf


def deltas(U, d, seed, device):
    """Heavy-tailed f32 deltas, user 1 (if any) all zero, made on the
    card."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((U, d), generator=g, device=device)
    spikes = torch.randperm(d, generator=g, device=device)[:max(1, d // 64)]
    x[:, spikes] *= 50.0
    if U > 1:
        x[1] = 0.0
    return x


def agg_tol(w, flat):
    """4 * G * eps32 * sum_g w_g * ||x_g||_inf: how far two orders of
    the same weighted sum of G reconstructions may land apart."""
    inf = flat.double().abs().amax(dim=1)
    return 4 * len(w) * EPS32 * float((w.double().abs() * inf).sum())


def time_ms(fn, iters):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def capture(fn, calls=1):
    """(graph, the last call's output): ``calls`` calls of ``fn``
    captured back to back in one CUDA graph, after a warm-up call on a
    side stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    return graph, out


def graph_ms(fn, calls, reps=5):
    """Device time per call of ``fn``, replayed from one CUDA graph that
    holds ``calls`` calls (no host dispatch between them), timed with
    CUDA events over ``reps`` replays."""
    graph, _ = capture(fn, calls)
    return time_ms(graph.replay, reps) / calls


def device_kernels(fn, calls):
    """What ``calls`` calls of ``fn`` run on the card, by
    ``torch.profiler``: {kernel, memset or copy name: (launches a call,
    device us a launch)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / calls, e.self_device_time_total / e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def device_us(kernels):
    """Summed device us a call of a :func:`device_kernels` result."""
    return sum(n * us for n, us in kernels.values())


def special_values(x):
    """Plant special values in deltas ``x`` [U, d]: user 0 gets NaN,
    +-inf, +-subnormals and -0.0; user 2 +-inf (an infinite max, where
    K1 and K2's cutoff takes its own branch); user 3 only subnormals (a
    subnormal max).  User 1 stays all zero."""
    import torch
    nan, inf = float("nan"), float("inf")
    x[0, :6] = torch.tensor([nan, inf, -inf, 1.4e-45, -1.4e-45, -0.0])
    if x.shape[0] > 3:
        x[2, 5:7] = torch.tensor([inf, -inf])
        x[3] *= 1e-39
    return x


def check_kernels(dev, U, d, lam, b, with_acc, specials=False):
    """Every kernel against its plain version on one input (K2 on both
    rules); returns the largest error of each (0.0 for bit-identical
    outputs)."""
    import torch
    from repro_torch.kernels import WirePath, mixed_res as mr, ops, ref

    x = deltas(U, d, seed=d + b, device=dev)
    if specials:
        special_values(x)
    x3 = ops.wire_view(x).contiguous()
    head_k = mr.mixed_res_reduce(x3, lam, d)
    head_p = ref.mixed_res_reduce_ref(x3, lam, d)
    wire_k = ops.mixed_res_encode(x3.reshape(U, -1)[:, :d], lam, b,
                                  path=WirePath(lowering="kernel"))
    head = wire_k.head
    planes_k = mr.mixed_res_emit(x3, head, b, d)
    planes_p = ref.mixed_res_emit_ref(x3, head, b, d)
    planes_k += mr.mixed_res_emit(x3, head, b, d, anchored=True)
    planes_p += ref.mixed_res_emit_ref(x3, head, b, d, anchored=True)
    w = torch.rand(U, generator=torch.Generator(device=dev).manual_seed(b),
                   device=dev) / U
    acc = torch.randn(x3.shape[1], 128, device=dev) if with_acc else None
    red_k = mr.mixed_res_dequant_reduce(*wire_k, w, b, acc=acc)
    red_p = ref.mixed_res_dequant_reduce_ref(*wire_k, w, b, acc=acc)
    torch.cuda.synchronize()
    errs = {"K1": max_abs_err(head_k, head_p),
            "K2": max(max_abs_err(k, p) for k, p in zip(planes_k, planes_p)),
            "K3": max_abs_err(red_k, red_p)}
    exact = {"K1": bitwise_equal(head_k, head_p),
             "K2": all(bitwise_equal(k, p)
                       for k, p in zip(planes_k, planes_p)),
             "K3": bitwise_equal(red_k, red_p)}
    if not all(exact.values()):
        raise AssertionError(f"kernel != plain at U={U} d={d} lam={lam} "
                             f"b={b} acc={with_acc} specials={specials}: "
                             f"errors {errs}")
    return errs, (x3, head, wire_k, w)


def check_wire_graph_and_cutoffs(dev, x3, head, lam, d, b):
    """K1 and K2 at the main shape captured once in a CUDA graph and
    replayed on new deltas copied in place, each replay bit for bit
    equal to the plain versions; two eager calls bit-identical; then
    the cutoff search K1 and K2 run, on 4000 (inf, lam) pairs, against
    its numpy twin ``ref.threshold_cutoff``."""
    import numpy as np
    import torch
    from repro_torch.kernels import mixed_res as mr, ops, ref

    U = x3.shape[0]
    xg = x3.clone()

    def both():
        return (mr.mixed_res_reduce(xg, lam, d),
                *mr.mixed_res_emit(xg, head, b, d))

    graph, out = capture(both)
    for seed in (21, 22):
        xg.copy_(ops.wire_view(deltas(U, d, seed=seed, device=dev)))
        graph.replay()
        want = (ref.mixed_res_reduce_ref(xg, lam, d),
                *ref.mixed_res_emit_ref(xg, head, b, d))
        torch.cuda.synchronize()
        if not all(bitwise_equal(k, p) for k, p in zip(out, want)):
            raise AssertionError("a graph replay of K1 and K2 disagrees "
                                 "with the plain versions")
    del graph
    first, second = both(), both()
    same = all(bitwise_equal(a, c) for a, c in zip(first, second))
    rng = np.random.default_rng(0)
    inf = (10.0 ** rng.uniform(-45, 38.5, 4000)).astype(np.float32)
    inf[:6] = [0.0, np.nan, np.inf, 1.4e-45, 3e38, np.inf]
    lams = np.array([0.0, 0.2, 1.0, 1e-30, 0.999999, -1.0, np.nan],
                    np.float32)[rng.integers(0, 7, 4000)]
    got = mr.cutoffs(torch.tensor(inf, device=dev),
                     torch.tensor(lams, device=dev)).cpu()
    cut_ok = bitwise_equal(got, mr.cutoffs(torch.tensor(inf),
                                           torch.tensor(lams)))
    print(f"K1 and K2 replayed from one CUDA graph on new deltas: bit-exact; "
          f"two eager calls bit-identical {same}; the cutoff search on the "
          f"card equals its numpy twin on 4000 (inf, lam) pairs {cut_ok}")
    if not (same and cut_ok):
        raise AssertionError("K1/K2 repeat or the cutoff search disagrees")


def time_encode(x3, lam, d, b, card, bound_ms, calls=20):
    """Device time by the profiler of the packed encode as
    ``ops.mixed_res_encode`` runs it on the main deltas (the pad to
    [U, W, 128] rows, K1, the torch epilogue, K2), and of the pad
    alone."""
    from repro_torch.kernels import ops

    U = x3.shape[0]
    flat = x3.reshape(U, -1)[:, :d].contiguous()
    enc = device_kernels(lambda: ops.mixed_res_encode(flat, lam, b), calls)
    pad = device_us(device_kernels(lambda: ops.wire_view(flat).contiguous(),
                                   calls))
    total = device_us(enc)
    by_name = [(k.replace("(anonymous namespace)::", "")
                .replace("void ", "").split("(")[0][:48], round(n * us, 2))
               for k, (n, us) in enc.items()]
    print(f"encode (mixed_res_encode, U={U}, d={d}, b={b}): {total:.2f} us "
          f"on the device; the pad to rows alone {pad:.2f} us, so K1 + "
          f"epilogue + K2 {total - pad:.2f} us against a bound of "
          f"{bound_ms * 1e3:.1f} us; by kernel {by_name} on {card}")


def check_sign_kernels(dev, G, d, edges):
    """K4 and K5 against their plain versions on one input, bit for bit;
    ``edges`` plants zeros, -0.0, NaN, +-inf and a positive subnormal.
    Returns the largest error of each and the inputs."""
    import torch
    from repro_torch.kernels import ops, quant_pack as qp, ref

    x = deltas(G, d, seed=d + G, device=dev)
    if edges:
        x[0, :7] = torch.tensor([0.0, -0.0, float("nan"), 1.4e-45,
                                 -1.4e-45, float("inf"), -float("inf")])
        x[-1, 7:40] = -0.0
    rows = ops.wire_view(x).reshape(-1, 128).contiguous()
    words_k = qp.signpack(rows)
    words_p = ref.signpack_ref(rows)
    words = words_k.reshape(G, -1, 4)
    scales = torch.rand(G, generator=torch.Generator(device=dev)
                        .manual_seed(d), device=dev) * 2 - 0.5
    red_k = qp.sign_dequant_reduce(words, scales)
    red_p = ref.sign_dequant_reduce_ref(words, scales)
    torch.cuda.synchronize()
    errs = {"K4": max_abs_err(words_k, words_p),
            "K5": max_abs_err(red_k, red_p)}
    if not (bitwise_equal(words_k, words_p) and bitwise_equal(red_k, red_p)):
        raise AssertionError(f"sign kernel != plain at G={G} d={d} "
                             f"edges={edges}: errors {errs}")
    if edges and int(words_k[0, 0]) & 0x7F != 0b0101000:
        raise AssertionError("K4 sign bits of 0, -0, NaN, +-subnormal, "
                             f"+-inf: {int(words_k[0, 0]) & 0x7F:#09b}")
    return errs, (rows, words, scales)


def sign_words(G, W, seed, device):
    """[G, W, 4] uint32 sign words, every bit pattern equally likely."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (G, W, 4), generator=g,
                         dtype=torch.int64, device=device) \
        .to(torch.int32).view(torch.uint32)


def check_k5(dev):
    """K5 alone against its plain version, bit for bit: random words at
    every G of ``K5_G`` and W of ``K5_W``; scales of 0.0, -0.0,
    subnormals, +-inf and NaN rotated over the peers at G in (1, 2, 3,
    40), where at G = 1 a scale of 0.0 must give -0.0 wherever the bit is
    clear; and one capture in a CUDA graph at the main shape, replayed on
    new words and scales copied in place.  Returns the cases checked."""
    import torch
    from repro_torch.kernels import quant_pack as qp, ref

    def exact(words, scales, out=None):
        got = qp.sign_dequant_reduce(words, scales) if out is None else out
        want = ref.sign_dequant_reduce_ref(words, scales)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            raise AssertionError(
                f"K5 != plain at G={words.shape[0]} W={words.shape[1]} "
                f"scales {scales[:8].tolist()}: max abs err "
                f"{max_abs_err(got, want)}")
        return got

    n = 0
    for G in K5_G:
        for W in K5_W:
            scales = torch.rand(G, generator=torch.Generator(device=dev)
                                .manual_seed(G), device=dev) * 2 - 0.5
            exact(sign_words(G, W, G * W, dev), scales)
            n += 1
    special = torch.tensor(K5_SPECIAL_SCALES, device=dev)
    for G in (1, 2, 3, 40):
        words = sign_words(G, 29, 7 + G, dev)
        for j in range(len(K5_SPECIAL_SCALES)):
            scales = special[(torch.arange(G, device=dev) + j)
                             % len(K5_SPECIAL_SCALES)]
            got = exact(words, scales)
            n += 1
            if G == 1 and j == 0:            # a scale of +0.0
                bits = ref._unpack(words[0], 1).reshape(29, 128) > 0
                if not (torch.equal(torch.signbit(got), ~bits)
                        and bool((got == 0.0).all())):
                    raise AssertionError("K5 at G=1 with a scale of 0.0 "
                                         "lost a -0.0")
    G, W = MAIN["U"], 3840
    words = sign_words(G, W, 1, dev)
    scales = torch.rand(G, device=dev) - 0.5
    graph, out = capture(lambda: qp.sign_dequant_reduce(words, scales))
    for seed in (2, 3):
        words.copy_(sign_words(G, W, seed, dev))
        scales.copy_(torch.rand(G, device=dev) * 4 - 2)
        graph.replay()
        exact(words, scales, out)
        n += 1
    return n


def check_many_users(dev):
    """K1 and K2 past one launch of users: U = 65,536 at d = 3610 (W =
    29), K1, the kernel encode (K1, epilogue, K2) and K2 on the anchored
    rule against their plain versions, bit for bit; each call launches
    one kernel a chunk of users.  Returns (K1, K2) launches counted."""
    import torch
    from repro_torch.kernels import (LAUNCHES, WirePath, mixed_res as mr,
                                     ops, ref)

    U, d, lam, b = MANY_USERS, 3610, MAIN["lam"], MAIN["b"]
    x = deltas(U, d, seed=U, device=dev)
    x3 = ops.wire_view(x).contiguous()
    before = (LAUNCHES["mixed_res_reduce"], LAUNCHES["mixed_res_emit"])
    pairs = [(mr.mixed_res_reduce(x3, lam, d),
              ref.mixed_res_reduce_ref(x3, lam, d))]
    wire = ops.mixed_res_encode(x, lam, b, path=WirePath(lowering="kernel"))
    plain = ops.mixed_res_encode(x, lam, b,
                                 path=WirePath(lowering="reference"))
    pairs += list(zip(wire, plain))
    pairs += list(zip(mr.mixed_res_emit(x3, wire.head, b, d, anchored=True),
                      ref.mixed_res_emit_ref(x3, wire.head, b, d,
                                             anchored=True)))
    torch.cuda.synchronize()
    if not all(bitwise_equal(k, p) for k, p in pairs):
        raise AssertionError(f"K1/K2 != plain at U={U} d={d}")
    launched = (LAUNCHES["mixed_res_reduce"] - before[0],
                LAUNCHES["mixed_res_emit"] - before[1])
    chunks = len(mr.user_chunks(U))
    if launched != (2 * chunks, 2 * chunks):
        raise AssertionError(f"K1/K2 launches at U={U}: {launched}, "
                             f"expected {2 * chunks} each")
    return launched


def narrow_reference_check(dev):
    """Two narrow rounds on the card against the same rounds on the CPU,
    from identical params and minibatches: the local deltas agree to
    1e-3 of their largest element (cuDNN and the CPU sum the gradients
    in different orders, and AdaGrad's 1/sqrt(G + 1e-8) magnifies the
    roundoff of near-zero gradients by up to alpha/1e-4), and the wire
    path on the same card deltas — K1–K3 on the
    card, the plain versions on the CPU — agrees bit for bit (planes,
    header, bits, aggregate).  Both then take the card's update."""
    import torch
    from repro_torch.configs.paper_cnn import PaperCNNConfig
    from repro_torch.core.quantize import MixedResolutionQuantizer
    from repro_torch.core.quantize.base import unflatten_pytree
    from repro_torch.fl.cnn import init_cnn
    from repro_torch.kernels import ops
    from repro_torch.sim import get_scenario, make_engine

    scn = dataclasses.replace(
        get_scenario("paper-table3"), aggregation="wire", K=4, T=2,
        n_train=160, n_test=40, batch_size=8, L=2, M=4, N=2, eval_every=1)
    init = init_cnn(torch.Generator().manual_seed(0), PaperCNNConfig())
    q = MixedResolutionQuantizer(MAIN["lam"], MAIN["b"])
    g = make_engine(scn, q, "bisection-lp", device=dev, init_params=init)
    c = make_engine(scn, q, "bisection-lp", device="cpu", init_params=init)
    gs, cs = g.start_run(), c.start_run()
    for t in range(1, scn.T + 1):
        xg, yg = g.draw_minibatches(gs)
        xc, yc = c.draw_minibatches(cs)
        with torch.no_grad():
            fg = g._batched_local(gs.params, xg, yg)
            fc = c._batched_local(cs.params, xc, yc)
            train_err = float((fg.cpu() - fc).abs().max() / fc.abs().max())
            outs = []
            for flat, w in ((fg, g._weights), (fg.cpu(), c._weights)):
                wire = ops.mixed_res_encode(flat, q.lambda_, q.b)
                agg, bits, _ = ops.mixed_res_wire_aggregate(
                    flat, w, q.lambda_, q.b)
                outs.append([t.cpu() for t in (*wire, agg, bits)])
            exact = all(bitwise_equal(a, b) for a, b in zip(*outs))
            upd = unflatten_pytree(outs[0][4].to(dev), g.spec)
            gs.params = {k: gs.params[k] + upd[k] for k in gs.params}
            cs.params = {k: v.cpu() for k, v in gs.params.items()}
        print(f"narrow round {t}, card vs CPU from identical params: "
              f"deltas max rel err {train_err:.3e} (<= 1e-3); wire path "
              f"on the same deltas bit-exact: {exact}")
        if not (train_err <= 1e-3 and exact):
            raise AssertionError("the narrow run on the card disagrees "
                                 "with the CPU's plain path")


def plane_agreement(eng):
    """One round's full-width deltas from the card through the three
    planes: signplane == dense == packed within the aggregation bound;
    then the card's signplane aggregate against the CPU's on the same
    deltas — the batched recons, the sign words (K4) and the sign-plane
    sum (K5) bit for bit, the aggregate within the bound (its weighted
    correction runs in cuBLAS on the card)."""
    import torch
    from repro_torch.dist import signplane_weighted_aggregate
    from repro_torch.kernels import ops

    q, w = eng.quantizer, eng._weights
    state = eng.start_run()
    xs, ys = eng.draw_minibatches(state)
    with torch.no_grad():
        flat = eng._batched_local(state.params, xs, ys)
        sign, bits, aux, _ = eng.aggregate(flat)
        res, _ = q.batched(flat)
        dense = torch.einsum("k,kd->d", w, res.recon)
        packed, pbits, _ = ops.mixed_res_wire_aggregate(flat, w, q.lambda_,
                                                         q.b)
        tol = agg_tol(w, flat)
        err_dense = float((sign - dense).abs().max())
        err_packed = float((packed - dense).abs().max())
        print(f"K={flat.shape[0]} d={flat.shape[1]}: |signplane - dense| "
              f"{err_dense:.3e}, |packed - dense| {err_packed:.3e}, bound "
              f"{tol:.3e}; bits equal on all three planes: "
              f"{bitwise_equal(bits, pbits)}")
        if not (err_dense <= tol and err_packed <= tol
                and bitwise_equal(bits, pbits)):
            raise AssertionError("the three planes disagree on the card")

        def sign_parts(f, weights):
            r, _ = q.batched(f)
            words = ops.signpack_op(ops.wire_view(f).reshape(-1))
            low = ops.packed_sign_weighted_sum(
                f, weights * r.aux["dw_q"] * 0.5)
            agg = signplane_weighted_aggregate(f, r.recon, r.aux["dw_q"],
                                               weights)
            return [t.cpu() for t in (r.recon, r.bits, words, low)], agg.cpu()

        card, card_agg = sign_parts(flat, w)
        cpu, cpu_agg = sign_parts(flat.cpu(), w.cpu())
    exact = [bitwise_equal(a, b) for a, b in zip(card, cpu)]
    err = float((card_agg - cpu_agg).abs().max())
    print(f"signplane, card vs CPU on the same deltas: recons, bits, K4 "
          f"words, K5 sum bit-exact {exact}; aggregate max abs err "
          f"{err:.3e} (bound {tol:.3e})")
    if not (all(exact) and err <= tol):
        raise AssertionError("the card's signplane aggregate disagrees "
                             "with the CPU's")


def drive(eng, rounds, per_round, label):
    """The main path's rounds on ``eng``, with the launch counters set
    to 0 just before and read just after; each round's launches must be
    ``per_round``.  Returns the counts over the run."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts

    d, b = eng.d, eng.quantizer.b
    state = eng.start_run()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    for t in range(1, rounds + 1):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        work_t = eng.train_round(state, t)
        uplink, per_user = eng.solve_uplink_host(state.chan, work_t.bits_np,
                                                 work_t.active)
        eng.finish_round(state, work_t, uplink, per_user_s=per_user)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        log = state.logs[-1]
        print(f"{label} round {t}: mean bits "
              f"{np.mean(log.bits_per_user):.1f}, uplink "
              f"{log.uplink_latency_s:.6f} s, cum latency "
              f"{log.cum_latency_s:.6f} s, acc {log.test_acc:.4f}, "
              f"mean s {log.mean_s:.5f}, wall {wall:.3f} s, "
              f"launches {delta}")
        if delta != per_round:
            raise AssertionError(f"{label} round {t} launches {delta}, "
                                 f"expected {per_round}")
        vals = [log.uplink_latency_s, log.cum_latency_s, log.test_acc,
                log.mean_s, *log.bits_per_user]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{label} round {t}: non-finite log {log}")
        lo, hi = d + 32.0, b * d + 32.0
        if not np.all((log.bits_per_user >= lo) & (log.bits_per_user <= hi)):
            raise AssertionError(f"{label} round {t}: bits outside "
                                 f"[{lo}, {hi}]")
    counts = dict(LAUNCHES)
    for k, v in state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite params in {k}")
    print(f"{label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches "
          f"over the {rounds} rounds {counts}")
    return counts, state


def round_breakdown(eng, state):
    """One more round, stage by stage, each closed by a synchronize:
    where a round's wall time goes (host clock, seconds)."""
    import numpy as np
    import torch
    from repro_torch.core.quantize.base import unflatten_pytree
    from repro_torch.dist import signplane_weighted_aggregate
    from repro_torch.kernels.ops import mixed_res_wire_aggregate

    q, w, out = eng.quantizer, eng._weights, {}
    plane = eng.wire_path_spec.plane

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return res

    xs, ys = stage("minibatch draw (host)",
                   lambda: eng.draw_minibatches(state))
    with torch.no_grad():
        flat = stage("local training (vmap, cuDNN)",
                     lambda: eng._batched_local(state.params, xs, ys))
        if plane == "packed":
            agg, bits, _ = stage("wire encode + reduce (K1, K2, K3)",
                                 lambda: mixed_res_wire_aggregate(
                                     flat, w, q.lambda_, q.b))
        else:
            res, _ = stage("batched quantize (vmap)",
                           lambda: q.batched(flat))
            agg = stage("signplane aggregate (K4, K5, correction einsum)",
                        lambda: signplane_weighted_aggregate(
                            flat, res.recon, res.aux["dw_q"], w))
            bits = res.bits
        upd = unflatten_pytree(agg, eng.spec)
        state.params = stage("param update", lambda: {
            k: state.params[k] + upd[k] for k in state.params})
    bits_np = stage("bits to host", lambda: bits.double().cpu().numpy())
    stage("power solve (host, scipy)", lambda: eng.solve_uplink_host(
        state.chan, bits_np, np.ones(eng.K)))
    stage("eval (1600 test images)", lambda: eng.model_spec.accuracy(
        state.params, state.test_x, state.test_y))
    total = sum(out.values())
    for name, sec in out.items():
        print(f"  {name}: {sec:.6f} s ({100 * sec / total:.1f}%)")
    print(f"  total {total:.6f} s")


def timed_stages(eng, stages=None):
    """Wrap the engine's stages in place, each closed by a synchronize;
    returns the dict their seconds add up in (cleared by the caller a
    round).  ``stages`` is ``(object, method, label)`` triples; by
    default the fused step's, where aggregate minus batched quantize is
    the weighted sum."""
    import torch
    times = {}

    def wrap(obj, attr, label):
        fn = getattr(obj, attr)

        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[label] = times.get(label, 0.0) + time.perf_counter() - t0
            return out
        setattr(obj, attr, run)

    for obj, attr, label in stages or (
            (eng, "_batched_local", "local training"),
            (eng.quantizer, "batched", "batched quantize"),
            (eng, "aggregate", "aggregate"),
            (eng, "solve_uplink_host", "host power solve")):
        wrap(obj, attr, label)
    return times


def exact_mode(dev):
    """``paper-table3`` at full width in the engine's exact mode (K=40
    users trained one by one through ``local_delta`` inside
    ``deterministic_cudnn``, one batched quantize, the left-to-right
    fold), ``EXACT_ROUNDS`` rounds with each round's wall time and stage
    split, against ``run_fl_sequential`` on the card from the same init
    params: bit for bit.  First, two identical per-user calls under the
    default cuDNN flags and inside ``deterministic_cudnn``."""
    import numpy as np
    import torch
    from _torch_parity import run_mismatches, same_bits
    from repro_torch.fl.cnn import init_cnn
    from repro_torch.fl.loop import (deterministic_cudnn, local_delta,
                                     run_fl_sequential)
    from repro_torch.sim import get_scenario
    from repro_torch.sim.scenarios import build_problem
    from repro_torch.sim.sweep import _make_engine

    scn = dataclasses.replace(get_scenario("paper-table3"), fused=False,
                              T=EXACT_ROUNDS, eval_every=1)
    problem = build_problem(scn)
    train, test, shards, cfg, chan = problem
    init = init_cnn(torch.Generator().manual_seed(0), cfg)
    q = ("mixed-resolution", {"lambda_": MAIN["lam"], "b": MAIN["b"]})
    eng = _make_engine(scn, problem, q, "bisection-lp", dev,
                       init_params=init)
    if eng.engine_cfg.effective_fused or eng.d != MAIN["d"]:
        raise AssertionError("expected the exact mode at full width")

    state = eng.start_run()
    xs, ys = eng.draw_minibatches(state)
    fl, loss = eng.fl, eng.model_spec.loss
    one = lambda: local_delta(state.params, xs[0], ys[0], fl.L, fl.alpha,
                              loss)
    with torch.no_grad():
        loose = same_bits(one(), one())
        with deterministic_cudnn():
            firm = [same_bits(one(), one()) for _ in range(3)]
    print(f"two identical per-user calls (user 0, L={fl.L}, batch "
          f"{eng.take}): default cuDNN flags bit for bit {loose}; inside "
          f"deterministic_cudnn {firm}")
    if not all(firm):
        raise AssertionError("deterministic_cudnn calls differ")
    del xs, ys

    times = timed_stages(eng, (
        (eng, "_per_user_local", "per-user training"),
        (eng.quantizer, "batched", "batched quantize"),
        (eng, "_exact_step", "step"),
        (eng, "solve_uplink_host", "host power solve")))
    state = eng.start_run()
    torch.cuda.synchronize()
    for t in range(1, EXACT_ROUNDS + 1):
        times.clear()
        t0 = time.perf_counter()
        work = eng.train_round(state, t)
        uplink, per_user = eng.solve_uplink_host(state.chan, work.bits_np,
                                                 work.active)
        eng.finish_round(state, work, uplink, per_user_s=per_user)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        split = {k: times[k] for k in ("per-user training",
                                       "batched quantize")}
        split["fold and update"] = times["step"] - sum(split.values())
        split["host power solve"] = times["host power solve"]
        split["rest (draw, bits to host, eval)"] = \
            wall - times["step"] - times["host power solve"]
        log = state.logs[-1]
        print(f"exact round {t}: wall {wall:.6f} s ("
              + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
              + f"); mean bits {np.mean(log.bits_per_user):.1f}, uplink "
              f"{log.uplink_latency_s:.6f} s, acc {log.test_acc:.4f}")
    exact = eng.result(state)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = run_fl_sequential(train, test, shards, cfg, eng.quantizer,
                            eng.power, chan, eng.fl, device=dev,
                            init_params=init)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bad = run_mismatches(exact, seq)
    print(f"run_fl_sequential, {EXACT_ROUNDS} rounds from the same init: "
          f"{secs:.3f} s; exact mode bit for bit (params, bits, latency, "
          f"mean s, accuracy): {not bad}")
    if bad:
        raise AssertionError(f"the exact mode differs from "
                             f"run_fl_sequential: {bad[:8]}")


def churn(dev):
    """``churn-0.7`` (K=20, participation 0.7) at full width for
    ``CHURN_ROUNDS`` rounds on each of the packed and signplane planes
    (mixed-resolution(0.2, 10)) and the dense plane with LAQ, each with
    the launch counters zeroed just before and read just after
    (``_torch_parity.churn_rounds``): every K1-K5 launch bit for bit
    its plain version on the same inputs, absent users' weights and
    scales exactly 0, LAQ's absent users' state unchanged, absent users'
    bits and latencies 0.  Prints each round's active count, sub-channel
    uplink and wall time; returns the launch counts by plane."""
    import torch
    from _torch_parity import churn_rounds
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.sim import get_scenario, make_engine

    expect = {"packed": ("mixed_res_reduce", "mixed_res_emit",
                         "mixed_res_dequant_reduce"),
              "signplane": ("signpack", "sign_dequant_reduce"),
              "dense/laq": ()}
    counts = {}
    for label, (agg, q) in CHURN_PLANES.items():
        scn = dataclasses.replace(get_scenario("churn-0.7"), aggregation=agg,
                                  T=CHURN_ROUNDS, eval_every=1)
        eng = make_engine(scn, q, "bisection-lp", device=dev)
        if eng.d != MAIN["d"] or eng.engine_cfg.participation != 0.7:
            raise AssertionError("expected churn-0.7 at full width")
        torch.cuda.synchronize()
        reset_launch_counts()
        absent, checked = 0, {}
        for work, log, info in churn_rounds(eng, CHURN_ROUNDS):
            absent += eng.K - info["active"]
            for k, v in info["calls"].items():
                checked[k] = checked.get(k, 0) + v
            on = work.bits_np[work.active > 0]
            print(f"churn {label} round {log.round}: active "
                  f"{info['active']} of {eng.K}, sub-channel uplink "
                  f"{log.uplink_latency_s:.6f} s, bits of the active "
                  f"{on.min():.0f}..{on.max():.0f}, acc "
                  f"{log.test_acc:.4f}, wall {info['wall']:.6f} s, "
                  f"K1-K5 launches held to their plain versions "
                  f"{info['calls']}")
            if not math.isfinite(log.cum_latency_s) or log.cum_latency_s <= 0:
                raise AssertionError(f"churn {label}: bad log {log}")
        torch.cuda.synchronize()
        got = dict(LAUNCHES)
        want = {k: CHURN_ROUNDS if k in expect[label] else 0 for k in got}
        if got != want:
            raise AssertionError(f"churn {label}: launches {got}, expected "
                                 f"{want}")
        if absent == 0:
            raise AssertionError(f"churn {label}: no user was absent")
        spied = {"packed": "mixed_res_dequant_reduce",
                 "signplane": "sign_dequant_reduce"}.get(label)
        if spied and checked.get(spied) != CHURN_ROUNDS:
            raise AssertionError(f"churn {label}: checked {checked}")
        print(f"churn {label}: {absent} absent uploads over "
              f"{CHURN_ROUNDS} rounds; launches {got}; K1-K5 bit for "
              f"bit their plain versions, K3 and K5 at absent users' zero "
              f"weights and scales; absent users' quantizer state "
              f"unchanged")
        counts[label] = got
        del eng
    return counts


def redraws(dev):
    """``monte-carlo-channel`` (K=20, a new large-scale realization every
    round) at full width, 3 rounds on its dense plane: each round's
    channel arrays equal ``make_channel(cfg, seed=channel_seed + t)``
    computed apart on the host (the scenario's own channel in round 1),
    and the uplink differs from round to round."""
    import numpy as np
    import torch
    from repro_torch.core.channel import make_channel
    from repro_torch.sim import get_scenario, make_engine

    scn = dataclasses.replace(get_scenario("monte-carlo-channel"), T=3,
                              eval_every=1)
    eng = make_engine(scn, ("mixed-resolution", {"lambda_": 0.2, "b": 10}),
                      "bisection-lp", device=dev)
    state = eng.start_run()
    uplinks = []
    for t in range(1, scn.T + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = eng.train_round(state, t)
        uplink, per_user = eng.solve_uplink_host(state.chan, work.bits_np,
                                                 work.active)
        eng.finish_round(state, work, uplink, per_user_s=per_user)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = eng.chan if t == 1 else make_channel(
            eng.chan.cfg, seed=eng.engine_cfg.channel_seed + t)
        same = all(np.array_equal(getattr(state.chan, f), getattr(want, f))
                   for f in ("beta", "pilot", "gamma", "A_bar", "B_bar",
                             "B_tilde", "I_M"))
        uplinks.append(uplink)
        print(f"redraw round {t}: channel seed "
              f"{scn.seed if t == 1 else eng.engine_cfg.channel_seed + t}, "
              f"arrays equal the host's make_channel {same}, sum A_bar "
              f"{float(state.chan.A_bar.sum()):.6e}, uplink {uplink:.6f} s, "
              f"acc {state.logs[-1].test_acc:.4f}, wall {wall:.6f} s")
        if not same:
            raise AssertionError(f"redraw round {t}: channel differs")
    if len(set(uplinks)) != len(uplinks):
        raise AssertionError(f"the uplink did not change: {uplinks}")


# ------------------------------------------------ the batched phy phase
@contextlib.contextmanager
def patched(pairs):
    """Each ``(owner, attr, hook)`` has ``owner.attr`` replaced by
    ``hook(original)`` for the duration; the originals come back
    after."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in pairs]
    try:
        for owner, attr, hook in pairs:
            setattr(owner, attr, hook(getattr(owner, attr)))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def stopwatch(times, label):
    """A hook for :func:`patched`: each call's seconds, closed by a
    synchronize on both sides, appended to ``times[label]``."""
    import torch

    def hook(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times.setdefault(label, []).append(time.perf_counter() - t0)
            return out
        return run
    return hook


def rel_err(got, want, floor):
    """max |got - want| / max(|want|, floor), in float64 on the host."""
    import numpy as np
    g = got.double().cpu().numpy() if hasattr(got, "cpu") \
        else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), floor)))


class Checks:
    """Named checks of a phase: each prints its value beside its limit;
    :meth:`done` raises if any failed."""

    def __init__(self, phase_name):
        self.phase_name, self.failed = phase_name, []

    def at_most(self, label, value, limit):
        ok = value <= limit
        print(f"  {label}: {value:.3e} (limit {limit:.0e}) "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            self.failed.append(label)

    def true(self, label, ok, detail=""):
        print(f"  {label}: {'ok' if ok else 'FAILED'} {detail}".rstrip())
        if not ok:
            self.failed.append(label)

    def done(self):
        if self.failed:
            raise AssertionError(f"{self.phase_name}: failed {self.failed}")


def phy_solvers(dev):
    """(a) The batched solvers on the card at ``PHY_REALIZATIONS``
    realizations of ``paper-table3``'s channel (K=40, M=16, N=4; seeds
    0..63) with packed-plane payloads ``d (b s + 1 - s) + 32``, against
    the port's numpy controllers one realization at a time: float64 with
    forward differences within DESIGN.md section 7's x64 contract,
    float32 within its f32 contract (rates within 1e-2 or the float32
    rounding of ``1 + SINR``), every p in [0, 1].  Then each
    float32 solve's time at batch 1 and 64 (warm, median of 5, closed by
    a synchronize) beside the numpy loop's."""
    import numpy as np
    import torch
    from repro_torch import phy
    from repro_torch.core.channel import CFmMIMOConfig, make_channel
    from repro_torch.sim import get_scenario
    from repro_torch.sim.sweep import _make_power

    scn = get_scenario("paper-table3")
    cfg = CFmMIMOConfig(M=scn.M, N=scn.N, K=scn.K)
    n, d, b = PHY_REALIZATIONS, MAIN["d"], MAIN["b"]
    chans = [make_channel(cfg, seed=s) for s in range(n)]
    s_frac = np.random.default_rng(0).uniform(0.005, 0.05, (n, cfg.K))
    bits = d * (b * s_frac + 1.0 - s_frac) + 32.0
    ctrls = {name: _make_power(spec) for name, spec in PHY_POWERS.items()}
    ctrls["max-sum-rate, 5 iterations"] = _make_power(
        ("max-sum-rate", {"iters": 5}))
    ctrls["max-sum-rate, defaults"] = _make_power("max-sum-rate")
    refs, host_s = {}, {}
    for name, ctrl in ctrls.items():
        t0 = time.perf_counter()
        refs[name] = [ctrl.solve(c, bits[i]) for i, c in enumerate(chans)]
        host_s[name] = time.perf_counter() - t0
    print(f"numpy controllers over the {n} realizations: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in host_s.items()))
    rates = {k: np.stack([r.rates for r in v]) for k, v in refs.items()}
    info = lambda name, key: [r.info[key] for r in refs[name]]
    cbs = {dt: phy.bundle_from_realizations(chans, dtype=dt, device=dev)
           for dt in (torch.float64, torch.float32)}
    solve = lambda name, dt, **kw: phy.batched_solver(ctrls[name])(
        cbs[dt], bits, **kw)
    ck = Checks("batched solvers")

    def box(label, sol):
        p = sol.p.double().cpu().numpy()
        ck.true(f"{label}: every p in [0, 1]",
                bool(np.all((p >= 0.0) & (p <= 1.0))))

    def f32_rates(label, got, want, p):
        """float32 rates against the numpy ones: within the f32
        contract's 1e-2, or where larger within the rounding of
        ``1 + SINR`` in float32, 2^-23 / ln(1 + SINR) relative: at
        K=40 some users sit at SINR ~3e-6 and lose ~1e-2 there (the JAX
        package's f32 rates alike, on the CPU)."""
        sinr = np.stack([c.sinr(p[i]) for i, c in enumerate(chans)])
        err = np.abs(got.double().cpu().numpy() - want) / np.abs(want)
        limit = np.maximum(1e-2, 2.0 ** -23 / np.log1p(sinr))
        worst = np.unravel_index(np.argmax(err / limit), err.shape)
        ck.true(f"{label}: within max(1e-2, 2^-23 / ln(1 + SINR))",
                bool(np.all(err <= limit)),
                f"(max err {err.max():.3e}; worst against its limit "
                f"{err[worst]:.3e} of {limit[worst]:.3e} at SINR "
                f"{sinr[worst]:.3e})")

    print("float64, forward differences, against the numpy controllers:")
    f64 = torch.float64
    sol = solve("bisection-lp", f64)
    box("bisection", sol)
    ck.at_most("bisection eta", rel_err(
        sol.info["eta"], info("bisection-lp", "eta"), 1e-12), 1e-5)
    ck.at_most("bisection rates", rel_err(sol.rates, rates["bisection-lp"],
                                          0.0), 1e-5)
    sol = solve("dinkelbach", f64)
    box("dinkelbach", sol)
    ck.at_most("dinkelbach rates", rel_err(sol.rates, rates["dinkelbach"],
                                           0.0), 1e-5)
    sol = solve("max-sum-rate, 5 iterations", f64)
    box("max-sum-rate, 5 iterations", sol)
    ck.at_most("max-sum-rate rates, 5 iterations (floor 1 bit/s)",
               rel_err(sol.rates, rates["max-sum-rate, 5 iterations"], 1.0),
               1e-5)
    sol = solve("max-sum-rate, defaults", f64)
    box("max-sum-rate, defaults", sol)
    short = 1.0 - np.min(sol.info["sum_rate"].double().cpu().numpy()
                         / np.array(info("max-sum-rate, defaults",
                                         "sum_rate")))
    ck.at_most("max-sum-rate at its defaults: sum rate short of the "
               "reference's by", short, 5e-2)

    print("float32, autodiff (the driver's precision), against the numpy "
          "controllers:")
    f32 = torch.float32
    p = np.random.default_rng(1).uniform(0.05, 1.0, (n, cfg.K)).astype(
        np.float32).astype(np.float64)
    f32_rates("rate evaluation", cbs[f32].rates(
        torch.as_tensor(p, dtype=f32, device=dev)),
        np.stack([c.rates(p[i]) for i, c in enumerate(chans)]), p)
    sol = solve("bisection-lp", f32)
    box("bisection", sol)
    ck.at_most("bisection eta", rel_err(
        sol.info["eta"], info("bisection-lp", "eta"), 1e-12), 1e-3)
    ck.at_most("bisection rates", rel_err(sol.rates, rates["bisection-lp"],
                                          0.0), 1e-3)
    sol = solve("dinkelbach", f32, grad_mode="fd")
    f32_rates("dinkelbach rates, forward differences (the all-ones fixed "
              "point)", sol.rates, rates["dinkelbach"],
              np.stack([r.p for r in refs["dinkelbach"]]))
    sol = solve("dinkelbach", f32)
    box("dinkelbach", sol)
    ee = sol.info["energy_efficiency"].double().cpu().numpy()
    ck.at_most("dinkelbach, autodiff: energy efficiency short of the "
               "reference's by", 1.0 - np.min(
                   ee / np.array(info("dinkelbach", "energy_efficiency"))),
               5e-2)
    trace = sol.info["ee_trace"].double().cpu().numpy()
    ck.true("dinkelbach ee_trace monotone",
            bool(np.all(np.diff(trace, axis=-1) >= 0.0)))
    sol = solve("max-sum-rate, defaults", f32)
    box("max-sum-rate, defaults", sol)
    ck.at_most("max-sum-rate, autodiff: sum rate short of the reference's "
               "by", 1.0 - np.min(sol.info["sum_rate"].double().cpu().numpy()
                                  / np.array(info("max-sum-rate, defaults",
                                                  "sum_rate"))), 5e-2)
    ck.done()

    for name in PHY_POWERS:
        row = {}
        for batch in (1, n):
            cb = phy.bundle_from_realizations(chans[:batch], device=dev)
            fn = lambda: phy.batched_solver(ctrls[name])(cb, bits[:batch])
            fn()
            secs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            row[f"card, batch {batch}"] = statistics.median(secs)
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            ctrls[name].solve(chans[0], bits[0])
            secs.append(time.perf_counter() - t0)
        row["numpy, batch 1"] = statistics.median(secs)
        row[f"numpy loop, batch {n}"] = host_s[name]
        print(f"{name}: " + ", ".join(f"{k} {v:.6f} s"
                                       for k, v in row.items())
              + f"; at batch {n} the numpy loop takes "
              f"{row[f'numpy loop, batch {n}'] / row[f'card, batch {n}']:.1f}"
              "x the card's time")


def phy_lockstep(dev):
    """(b) ``run_grid_batched`` at full width: ``paper-table3`` on the
    packed plane, mixed-resolution(0.2, 10) x the three controllers of
    ``PHY_POWERS``, ``PHY_ROUNDS`` rounds, the launch counters zeroed
    just before and read just after: one K1, K2, K3 a round, since one
    training track serves the three power cells.  Prints each round's
    training and batched-solve seconds.  Against the host ``run_grid``
    on the same rounds (all three inside ``deterministic_cudnn``, so the
    same training gives the same bits): bits exact in every cell;
    bisection-LP's float32 uplinks within 2e-2 (DESIGN.md section 7's
    f32 contract); the same driver in float64 (forward differences)
    within 1e-5 for all three controllers.  In float32 the ascent
    controllers differentiate by autodiff, as in the JAX driver, and
    reach other optima than the host's forward differences: their ratio
    to the host uplink is printed.  Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.fl.loop import deterministic_cudnn
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.sim import (VectorizedFLEngine, get_scenario, run_grid,
                                 run_grid_batched)
    from repro_torch.sim import phy_driver

    scn = dataclasses.replace(get_scenario("paper-table3"), aggregation="wire",
                              T=PHY_ROUNDS, eval_every=1)
    q = {"mixed-resolution": ("mixed-resolution",
                              {"lambda_": MAIN["lam"], "b": MAIN["b"]})}
    times = {}
    with deterministic_cudnn(), patched([
            (VectorizedFLEngine, "train_round", stopwatch(times, "train")),
            (phy_driver, "_solve_round_batched", stopwatch(times, "solve"))]):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        f32 = run_grid_batched([scn], q, PHY_POWERS, quick=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    for t in range(PHY_ROUNDS):
        print(f"lockstep round {t + 1}: training (one track) "
              f"{times['train'][t]:.6f} s, batched solve (3 power specs) "
              f"{times['solve'][t]:.6f} s")
    print(f"lockstep run: {wall:.3f} s in all ({PHY_ROUNDS} rounds, 3 cells, "
          f"setup included); launches {counts}")
    ck = Checks("lockstep driver")
    kernels = ("mixed_res_reduce", "mixed_res_emit", "mixed_res_dequant_reduce")
    ck.true("K1, K2, K3 once a round for the three cells",
            counts == {k: PHY_ROUNDS if k in kernels else 0 for k in counts},
            str(counts))
    with deterministic_cudnn():
        f64 = run_grid_batched([scn], q, PHY_POWERS, quick=False, device=dev,
                               dtype=torch.float64)
        host = run_grid([scn], q, PHY_POWERS, quick=False, device=dev)
    for rf, rd, rh in zip(f32, f64, host, strict=True):
        label = rh.cell.power_label
        up = {k: np.array([l.uplink_latency_s for l in r.result.logs])
              for k, r in (("f32", rf), ("f64", rd), ("host", rh))}
        ck.true(f"{label}: bits equal the host's in every round (float32 "
                "and float64 runs)", all(
                    np.array_equal(a.bits_per_user, c.bits_per_user)
                    and np.array_equal(b_.bits_per_user, c.bits_per_user)
                    for a, b_, c in zip(rf.result.logs, rd.result.logs,
                                        rh.result.logs, strict=True)))
        print(f"  {label}: host uplinks {up['host']}, float32 / host "
              f"{up['f32'] / up['host']}, max_p {rf.summary['max_p']:.6f}")
        ck.true(f"{label}: max_p in (0, 1]",
                0.0 < rf.summary["max_p"] <= 1.0)
        ck.at_most(f"{label}: float64 uplinks against the host's",
                   rel_err(up["f64"], up["host"], 0.0), 1e-5)
        if label == "bisection-lp":
            ck.at_most(f"{label}: float32 uplinks against the host's",
                       rel_err(up["f32"], up["host"], 0.0), 2e-2)
    ck.done()
    return {k: counts[k] for k in kernels}


def phy_replicates(dev):
    """(c) The replicate axis at full width.  ``monte-carlo-replicated``
    (K=20, R=8, the dense plane; ``"auto"`` is ``"vmap"`` on the card)
    for ``REPL_ROUNDS`` rounds through ``run_grid_batched``: each
    round's train, solve, eval and finish seconds and the peak device
    memory; the 8 replicates' channels distinct.  R = 1 against the
    unreplicated driver: bit for bit.  R = 2 on the packed and the
    signplane planes (one replicate at a time), ``REPL_ROUNDS`` rounds
    each with the counters zeroed: K1-K3 or K4-K5 launch R x rounds
    times, each launch bit for bit its plain version on the same inputs
    (``_torch_parity.WireSpy``), and replicate 0 the unreplicated run
    of that plane bit for bit.  The runs that are compared train inside
    ``deterministic_cudnn``.  Returns the launch counts."""
    import numpy as np
    import torch
    from _torch_parity import WireSpy, same_bits
    from repro_torch.fl.loop import deterministic_cudnn
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.sim import (VectorizedFLEngine, get_scenario,
                                 make_engine, run_grid_batched)
    from repro_torch.sim import phy_driver

    scn = dataclasses.replace(get_scenario("monte-carlo-replicated"),
                              T=REPL_ROUNDS, eval_every=1)
    R = scn.replicates
    q = ("mixed-resolution", {"lambda_": MAIN["lam"], "b": MAIN["b"]})
    qs, ps = {"mixed-resolution": q}, {"bisection-lp": "bisection-lp"}
    ck = Checks("replicates")
    times, grids, modes = {}, [], []

    def record_grid(fn):
        def run(grid, *args, **kw):
            grids.append([list(row) for row in grid])
            return fn(grid, *args, **kw)
        return run

    def record_mode(fn):
        def run(self, n):
            step = fn(self, n)
            modes.append(step.__name__)
            return step
        return run

    with patched([
            (VectorizedFLEngine, "train_round_replicated",
             stopwatch(times, "train")),
            (phy_driver, "_solve_round_replicated", stopwatch(times, "solve")),
            (VectorizedFLEngine, "eval_accuracy_replicated",
             stopwatch(times, "eval")),
            (phy_driver, "_finish_replicated_cell",
             stopwatch(times, "finish")),
            (phy_driver, "bundle_from_realization_grid", record_grid),
            (VectorizedFLEngine, "_replicated_step", record_mode)]):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = run_grid_batched([scn], qs, ps, quick=False, device=dev)[0]
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    for t in range(REPL_ROUNDS):
        split = {k: times[k][t] for k in ("train", "solve", "eval", "finish")}
        print(f"monte-carlo-replicated round {t + 1} (R={R}, K={scn.K}): "
              f"{sum(split.values()):.6f} s = "
              + " + ".join(f"{k} {v:.6f}" for k, v in split.items()))
    s = res.summary
    print(f"  peak device memory {peak:.1f} MiB; summary: total latency "
          f"{s['total_latency_s']:.6f} +- {s['total_latency_s_ci95']:.6f} s,"
          f" best acc {s['best_acc']:.4f} +- {s['best_acc_ci95']:.4f}, "
          f"max_p {s['max_p']:.6f}")
    ck.true("the replicated step ran under vmap", modes == ["step_vmap"] *
            REPL_ROUNDS, str(modes))
    a_bars = [c.A_bar for c in grids[0][0]]
    ck.true(f"the {R} replicates' channels are distinct", len(a_bars) == R
            and all(not np.array_equal(a_bars[i], a_bars[j])
                    for i in range(R) for j in range(i + 1, R)))
    ck.true("summary finite, ci95 > 0 on the latency", all(
        math.isfinite(s[k]) for k in ("total_latency_s",
                                      "total_latency_s_ci95", "best_acc"))
        and s["total_latency_s_ci95"] > 0 and s["replicates"] == R)

    one = dataclasses.replace(scn, replicates=1)
    with deterministic_cudnn():
        plain = run_grid_batched([one], qs, ps, quick=False, device=dev)[0]
        rep1 = run_grid_batched([one], qs, ps, quick=False, device=dev,
                                replicates=1)[0]
    a, b_ = plain.result, rep1.result[0]
    ck.true("R = 1 is the unreplicated run bit for bit (bits, accuracy, "
            "mean s, params)", all(
                np.array_equal(x.bits_per_user, y.bits_per_user)
                and x.test_acc == y.test_acc and x.mean_s == y.mean_s
                for x, y in zip(a.logs, b_.logs, strict=True))
            and all(same_bits(a.params[k], b_.params[k]) for k in a.params))
    ck.at_most("R = 1 uplinks against the unreplicated run's", rel_err(
        [l.uplink_latency_s for l in b_.logs],
        [l.uplink_latency_s for l in a.logs], 0.0), 1e-9)

    counts = {}
    for plane, agg, kernels in (
            ("packed", "wire", ("mixed_res_reduce", "mixed_res_emit",
                                "mixed_res_dequant_reduce")),
            ("signplane", "signplane", ("signpack", "sign_dequant_reduce"))):
        eng = make_engine(dataclasses.replace(scn, aggregation=agg), q,
                          "bisection-lp", device=dev)
        with deterministic_cudnn():
            st = eng.start_replicated_run(2)
            torch.cuda.synchronize()
            reset_launch_counts()
            with WireSpy() as spy:
                works = [eng.train_round_replicated(st, t)
                         for t in range(1, REPL_ROUNDS + 1)]
                torch.cuda.synchronize()
            got = dict(LAUNCHES)
            checked = spy.check(np.zeros(eng.K))
            un = eng.start_run()
            uworks = [eng.train_round(un, t)
                      for t in range(1, REPL_ROUNDS + 1)]
        n = 2 * REPL_ROUNDS
        ck.true(f"{plane}, R = 2: launches R x rounds", got == {
            k: n if k in kernels else 0 for k in got}, str(got))
        ck.true(f"{plane}, R = 2: every launch bit for bit its plain version",
                checked == {k: n for k in kernels}, str(checked))
        ck.true(f"{plane}, R = 2: replicate 0 is the unreplicated run bit "
                "for bit", all(np.array_equal(w.bits_np[0], u.bits_np)
                               and w.mean_s[0] == u.mean_s
                               for w, u in zip(works, uworks))
                and all(same_bits(st.params[k][0], un.params[k])
                        for k in un.params))
        ck.true(f"{plane}, R = 2: replicate 1 trains on other data",
                not np.array_equal(works[0].bits_np[1], works[0].bits_np[0]))
        counts.update({k: got[k] for k in kernels})
        del eng, st, un
    ck.done()
    return counts


def drive_baseline(eng, rounds, qlabel, label):
    """``rounds`` rounds of ``eng`` through its round-stepping API, on the
    dense plane: no wire kernel launches.  Prints each round's wall time,
    its stage split and the peak device memory; checks each user's bits
    against the quantizer's payload rule and that every logged number
    and param is finite.  Returns the per-round logs."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES

    from _torch_parity import payload_rule

    rule, ok = payload_rule(qlabel, eng.d)
    times = timed_stages(eng)
    state = eng.start_run()
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for t in range(1, rounds + 1):
        times.clear()
        t0 = time.perf_counter()
        work = eng.train_round(state, t)
        uplink, per_user = eng.solve_uplink_host(state.chan, work.bits_np,
                                                 work.active)
        eng.finish_round(state, work, uplink, per_user_s=per_user)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log = state.logs[-1]
        split = {"local training": times["local training"],
                 "batched quantize": times["batched quantize"],
                 "weighted sum": times["aggregate"]
                 - times["batched quantize"],
                 "host power solve": times["host power solve"]}
        split["rest (draw, update, eval)"] = wall - sum(split.values())
        print(f"{label} round {t}: wall {wall:.6f} s ("
              + ", ".join(f"{k} {v:.6f}" for k, v in split.items())
              + f"); peak {torch.cuda.max_memory_allocated() / 2**20:.1f} "
              f"MiB; bits min {log.bits_per_user.min():.0f} max "
              f"{log.bits_per_user.max():.0f}, uplink "
              f"{log.uplink_latency_s:.6f} s, acc {log.test_acc:.4f}")
        if not np.all(ok(log.bits_per_user)):
            raise AssertionError(f"{label} round {t}: bits "
                                 f"{log.bits_per_user} break {rule}")
        vals = [log.uplink_latency_s, log.cum_latency_s, log.test_acc,
                log.mean_s]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{label} round {t}: non-finite log {log}")
    if dict(LAUNCHES) != before:
        raise AssertionError(f"{label}: the dense plane launched wire "
                             "kernels")
    for k, v in state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite params in {k}")
    print(f"{label}: bits {rule} in every round")
    return state.logs


def baselines(dev):
    """The paper's baselines at full width on the dense plane of
    ``paper-table3``: each quantizer's ``batched`` on the card against the
    CPU on one round's deltas; rounds of classic, top-q, LAQ and AQUILA
    under bisection-LP, and of mixed-resolution(0.4, 4) under Dinkelbach
    and max-sum-rate; then the Table III script in quick mode."""
    import numpy as np
    import torch
    from _torch_parity import baseline_card_vs_cpu
    from benchmarks import torch_table3_latency as t3
    from repro_torch.core.quantize import make_quantizer
    from repro_torch.sim import get_scenario
    from repro_torch.sim.scenarios import build_problem
    from repro_torch.sim.sweep import _make_engine

    scn = dataclasses.replace(get_scenario("paper-table3"), T=ROUNDS,
                              eval_every=1)
    if scn.engine_config().wire.plane != "dense":
        raise AssertionError("paper-table3 is registered on the dense plane")
    problem = build_problem(scn)       # one problem, as run_grid builds
    make = lambda q, pc, s=scn: _make_engine(s, problem, q, pc, dev)
    eng = make(BASELINES["classic"], "bisection-lp")
    state = eng.start_run()
    flats = []
    with torch.no_grad():
        for _ in range(3):
            xs, ys = eng.draw_minibatches(state)
            flats.append(eng._batched_local(state.params, xs, ys))
        print(f"three rounds' deltas from the card: {tuple(flats[0].shape)}")
        for qlabel, (name, kw) in BASELINES.items():
            t0 = time.perf_counter()
            found = baseline_card_vs_cpu(lambda: make_quantizer(name, **kw),
                                         flats if name == "laq" else flats[:1])
            print(f"{qlabel} {kw}, card vs CPU: agree ({found}; "
                  f"{time.perf_counter() - t0:.2f} s)")
    del eng, state, flats

    for qlabel, spec in BASELINES.items():
        logs = drive_baseline(make(spec, "bisection-lp"), BASELINE_ROUNDS,
                              qlabel,
                              f"{qlabel}/bisection-lp")
        if qlabel == "laq":
            skips = sum(int(np.sum(l.bits_per_user == 0.0)) for l in logs)
            n = BASELINE_ROUNDS
            print(f"laq skipped {skips} uploads in {n} rounds of {scn.K} "
                  "users" if skips else
                  f"laq did not skip in {n} rounds of {scn.K} users "
                  "(xi = 0.5 against the mean of 10 slots)")
    mixed = ("mixed-resolution", {"lambda_": 0.4, "b": 4})
    for plabel, pspec in BASELINE_POWERS.items():
        drive_baseline(make(mixed, pspec, dataclasses.replace(scn, T=2)), 2,
                       "mixed-resolution", f"mixed-resolution/{plabel}")

    t0 = time.perf_counter()
    out = ROOT / "runs" / "bench"
    lines = t3.run(quick=True, device=dev, out=str(out))
    for line in lines:
        print("  " + line)
    with open(out / "torch_table3.csv") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != 12 or not all(
            int(r["T_max"]) >= 1 and math.isfinite(float(r["mean_bits"]))
            and float(r["mean_bits"]) > 0 for r in rows):
        raise AssertionError(f"the Table III script's CSV is wrong: {rows}")
    print(f"Table III script, quick mode: 12 cells, "
          f"{time.perf_counter() - t0:.2f} s")


def kv_inputs(B, Hkv, G, S, D, Dv, dtype, seed, device):
    """q [B, Hkv*G, D] and caches [B, S, Hkv, D(v)] (the cache layout),
    standard normal, made on the card."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=device,
                                    dtype=torch.float32).to(dtype)
    return mk(B, Hkv * G, D), mk(B, S, Hkv, D), mk(B, S, Hkv, Dv)


def check_flash_decode(dev, B, Hkv, G, S, D, Dv, dtype, length):
    """K6 through ``flash_decode_op`` (caches in their layout, length on
    the card) against its plain version on the same inputs, within
    K6_TOL.  Returns the largest |difference| and share of the bound."""
    import torch
    from repro_torch.kernels import ops, ref

    dt = getattr(torch, dtype)
    q, k, v = kv_inputs(B, Hkv, G, S, D, Dv, dt, seed=S + G + length,
                        device=dev)
    n = torch.tensor(length, dtype=torch.int32, device=dev)
    got = ops.flash_decode_op(q, k, v, n).float()
    want = ref.flash_decode_ref(q.reshape(B, Hkv, G, D), k.transpose(1, 2),
                                v.transpose(1, 2), length)
    want = want.reshape(B, Hkv * G, Dv).float()
    torch.cuda.synchronize()
    err, share = k6_within(got, want, dtype)
    if share > 1.0:
        raise AssertionError(f"K6 != plain at B={B} Hkv={Hkv} G={G} S={S} "
                             f"D={D} Dv={Dv} {dtype} length={length}: max "
                             f"abs err {err:.3e}, {share:.2f} of the bound")
    return err, share


def k6_within(got, want, dtype):
    """(max |got - want|, the largest share of its bound K6_TOL that an
    element uses); the check passes when the share is <= 1."""
    atol, rtol = K6_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    bound = atol(want) + rtol * want.float().abs()
    return float(diff.max()), float((diff / bound).max())


def check_k6_graph_and_repeat(dev):
    """At the serve shape (bf16): one ``flash_decode_op`` call captured in
    a CUDA graph, replayed after the device ``length`` is changed in place
    to 1, 3, 4079 and 4096, each replay held to the plain version within
    K6_TOL (the split is sized on the card, so one capture serves every
    length); then two eager calls at full length, bit for bit equal; then
    one profiled call, which must run K6 alone: one kernel, no memset, no
    fill, no copy.  Returns the largest share of the bound."""
    import torch
    from repro_torch.kernels import ops, ref

    sv = K6_SERVE
    B, Hkv, G, S, D, Dv = (sv[k] for k in ("B", "Hkv", "G", "S", "D", "Dv"))
    q, k, v = kv_inputs(B, Hkv, G, S, D, Dv, torch.bfloat16, seed=11,
                        device=dev)
    n = torch.tensor(S, dtype=torch.int32, device=dev)
    graph, out = capture(lambda: ops.flash_decode_op(q, k, v, n))
    shares = {}
    for length in (1, 3, 4079, 4096):
        n.fill_(length)
        graph.replay()
        want = ref.flash_decode_ref(q.reshape(B, Hkv, G, D),
                                    k.transpose(1, 2), v.transpose(1, 2),
                                    length).reshape(B, Hkv * G, Dv)
        torch.cuda.synchronize()
        shares[length] = k6_within(out, want, "bfloat16")[1]
    del graph
    n.fill_(S)
    first, second = ops.flash_decode_op(q, k, v, n), \
        ops.flash_decode_op(q, k, v, n)
    same = torch.equal(first.view(torch.int16), second.view(torch.int16))
    ran = device_kernels(lambda: ops.flash_decode_op(q, k, v, n), 1)
    print(f"K6 graph replays at the serve shape, length changed in place "
          f"(share of the bound by length) {shares}; two calls bit-identical "
          f"{same}; one profiled call runs {ran}")
    if max(shares.values()) > 1.0:
        raise AssertionError(f"a graph replay of K6 disagrees with its plain "
                             f"version: {shares}")
    if not same:
        raise AssertionError("two K6 calls on the same inputs differ")
    if len(ran) != 1 or list(ran.values())[0][0] != 1 \
            or "k6_flash_decode" not in list(ran)[0]:
        raise AssertionError(f"one K6 call ran {ran}, not one K6 kernel")
    return max(shares.values())


def narrow_decode_check(dev):
    """Reduced granite-3-8b regrouped to 2 kv heads (G=2), f32: 12
    tokens of decode on the card through K6 and on the CPU through the
    plain version, from the same params; logits within 1e-4 of their
    largest, one K6 launch per layer and step."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import decode_step, init_cache, init_model
    from repro_torch.models.layers import tree_map

    cfg = dc.replace(get_config(SERVE["arch"]).reduced(), num_kv_heads=2,
                     dtype="float32")
    devs = {"host": torch.device("cpu"), "card": dev}
    host_p = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = {"host": host_p, "card": tree_map(lambda t: t.to(dev), host_p)}
    caches = {w: init_cache(cfg, 2, 40, cfg.dtype, device=d)
              for w, d in devs.items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    before = LAUNCHES["flash_decode"]
    worst = 0.0
    for t in range(tokens.shape[1]):
        out = {}
        for w, d in devs.items():
            idx = torch.tensor(t, dtype=torch.int32, device=d)
            lg, caches[w] = decode_step(params[w], caches[w],
                                        tokens[:, t:t + 1].to(d), idx, cfg)
            out[w] = lg.cpu()
        err = float((out["card"] - out["host"]).abs().max()
                    / out["host"].abs().max())
        worst = max(worst, err)
    launched = LAUNCHES["flash_decode"] - before
    print(f"narrow decode ({cfg.name}, kv heads 2, f32, 12 tokens), card "
          f"through K6 vs CPU plain: logits max rel err {worst:.3e} "
          f"(<= 1e-4); K6 launches {launched}")
    if worst > 1e-4 or launched != cfg.num_layers * tokens.shape[1]:
        raise AssertionError("the narrow decode on the card disagrees with "
                             "the CPU's plain path")


def k6_work(B, Hkv, G, S, D, Dv, dtype, length):
    """(bytes, operations) K6 must move and do at these inputs: q and
    the positions < length of k and v read once, the output written
    once; 2 operations per multiply-add of q.k and p.v."""
    import torch
    es = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    L = min(S, length)
    by = es * (B * Hkv * G * D + B * Hkv * L * (D + Dv) + B * Hkv * G * Dv)
    return by, 2 * B * Hkv * G * L * (D + Dv)


def time_flash_decode(dev, shape, dtype, card, iters, short=None):
    """K6, its plain version and one ``scaled_dot_product_attention``
    call (flash backend, ``enable_gqa``) on the same inputs at full
    length: CUDA events over ``iters`` eager calls (``ms``,
    ``library_ms``: the host's dispatch included), the same calls
    replayed from one CUDA graph (``graph_ms``, ``library_graph_ms``)
    and the kernels' own device time by the profiler
    (``kernel_us``, ``library_kernel_us``); with ``short``, K6 also at
    that length of the same cache.  Returns the timing row."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_decode as fd, ops, ref

    B, Hkv, G, S, D, Dv = (shape[k] for k in ("B", "Hkv", "G", "S", "D",
                                               "Dv"))
    dt = getattr(torch, dtype)
    q, k, v = kv_inputs(B, Hkv, G, S, D, Dv, dt, seed=7, device=dev)
    n = torch.tensor(S, dtype=torch.int32, device=dev)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)       # views, no copy
    got = ops.flash_decode_op(q, k, v, n)
    occ = fd.occupancy(dt, B, Hkv, G, D, Dv, S)

    def kernel():
        return ops.flash_decode_op(q, k, v, n)

    def plain():
        return ref.flash_decode_ref(q.reshape(B, Hkv, G, D), kt, vt, S)

    def library():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, enable_gqa=True)

    ms = time_ms(kernel, iters)
    lib_ms = time_ms(library, iters)
    g_ms, lib_g_ms = graph_ms(kernel, iters), graph_ms(library, iters)
    k_us = device_us(device_kernels(kernel, iters))
    lib_kernels = device_kernels(library, iters)
    lib_us = device_us(lib_kernels)
    row = {}
    if short is not None:
        n_short = torch.tensor(short, dtype=torch.int32, device=dev)
        short_call = lambda: ops.flash_decode_op(q, k, v, n_short)
        row = {"short_length": short,
               "short_graph_ms": graph_ms(short_call, iters),
               "short_kernel_us": device_us(device_kernels(short_call,
                                                           iters))}
    lib_err = float((library()[:, :, 0].float() - got.float()).abs().max())
    torch.cuda.reset_peak_memory_stats()
    plain_ms = time_ms(plain, 3)
    err, share = k6_within(got, plain().reshape(B, Hkv * G, Dv), dtype)
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    del q, k, v, kt, vt, got
    torch.cuda.empty_cache()
    mem_rate, _ = peaks(card.split(",")[0])
    op_rate = peaks(card.split(",")[0], BF16_PEAKS) if dtype == "bfloat16" \
        else peaks(card.split(",")[0])[1]
    by, ops_ = k6_work(B, Hkv, G, S, D, Dv, dtype, S)
    t_bytes, t_ops = by / mem_rate * 1e3, ops_ / op_rate * 1e3
    bound = max(t_bytes, t_ops)
    print(f"K6 at B={B} Hkv={Hkv} G={G} S={S} D={D} Dv={Dv} {dtype}: kernel "
          f"{ms:.4f} ms eager / {g_ms:.4f} ms in a graph / {k_us:.2f} us on "
          f"the device; sdpa (flash, gqa) {lib_ms:.4f} / {lib_g_ms:.4f} ms / "
          f"{lib_us:.2f} us ({len(lib_kernels)} kernels); plain "
          f"{plain_ms:.4f} ms; bound {bound * 1e3:.1f} us ({by / 1e6:.1f} "
          f"MB), K6 at {bound / (k_us / 1e3):.3f} of it on the device; "
          f"{occ}; |K6 - plain| {err:.3e} ({share:.3f} of the bound), "
          f"|K6 - sdpa| {lib_err:.3e}; peak device memory with the plain "
          f"version {plain_peak:.2f} GiB on {card}")
    if row:
        print(f"K6 at length {short} of the same cache: "
              f"{row['short_graph_ms'] * 1e3:.2f} us a call in a graph, "
              f"{row['short_kernel_us']:.2f} us on the device")
    if share > 1.0:
        raise AssertionError(f"K6 disagrees with its plain version at the "
                             f"timed shape: {err}, {share:.2f} of the bound")
    if occ["nsplit"] > 1 and B * Hkv > occ["clusters"]:
        raise AssertionError(f"K6's grid does not run in one wave: {occ}")
    return dict({"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound,
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                 "bytes": by, "library_ms": lib_ms, "max_abs_err": err,
                 "graph_ms": g_ms, "library_graph_ms": lib_g_ms,
                 "kernel_us": k_us, "library_kernel_us": lib_us,
                 "occupancy": occ}, **row)


def decode_breakdown(params, cfg, cache, idx, tok, ms_step, steps=4):
    """Where a full-width decode step's time goes: ``torch.profiler``
    over ``steps`` decode steps from cache position ``idx`` (after a
    warm-up step; ``idx`` advances in place) — the device's busy time
    (the sum of its kernels' times) against the host clock under the
    profiler and against ``ms_step``, the unprofiled step; K6's share of
    the busy time; the top ops by host time and the top kernels by
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step

    decode_step(params, cache, tok, idx, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            idx += 1
            decode_step(params, cache, tok, idx, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_time = lambda e: e.self_device_time_total
    busy_ms = sum(dev_time(e) for e in kernels) / 1e3 / steps
    k6 = [e for e in kernels if "flash_decode" in e.key]
    k6_ms = sum(dev_time(e) for e in k6) / 1e3 / steps
    k6_n = sum(e.count for e in k6) / steps
    print(f"decode step under the profiler: {1e3 * wall / steps:.3f} ms/step "
          f"wall, device busy {busy_ms:.3f} ms/step ({len(kernels)} kernel "
          f"names, {sum(e.count for e in kernels) / steps:.0f} launches/step);"
          f" idle share {1 - busy_ms / (1e3 * wall / steps):.3f} under the "
          f"profiler, {1 - busy_ms / ms_step:.3f} of the unprofiled "
          f"{ms_step:.3f} ms/step; K6 {k6_ms:.3f} ms/step "
          f"({k6_ms / max(busy_ms, 1e-9):.3f} of device busy, {k6_n:.0f} launches, "
          f"{1e3 * k6_ms / max(k6_n, 1):.1f} us a launch)")
    print("  top ops by host time (self, ms/step, calls/step):")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"    {e.key[:60]:60s} {e.self_cpu_time_total / 1e3 / steps:8.3f}"
              f" {e.count / steps:7.1f}")
    print("  top kernels by device time (ms/step, launches/step):")
    for e in sorted(kernels, key=lambda e: -dev_time(e))[:8]:
        print(f"    {e.key[:60]:60s} {dev_time(e) / 1e3 / steps:8.3f}"
              f" {e.count / steps:7.1f}")


def serve_long_context(params, cfg, prompts, steps=32):
    """Decode steps that read a nearly full cache: its positions below
    ``max_len - 64`` are filled with standard normal k/v (the weights
    are random, so there is no content to keep), then ``steps`` greedy
    steps run with the launch counters zeroed just before — 40 K6
    launches a step, each over 4033 to 4064 positions; then the
    profiler's breakdown of such steps; then one step's logits through
    K6 against the same step with K6's plain version in its place,
    within SERVE_LOGIT_TOL of max |logit|, and in that plain step each
    layer's K6 output against the plain one on the same inputs, within
    K6_TOL."""
    import torch
    from repro_torch.kernels import LAUNCHES, ops, ref, reset_launch_counts
    from repro_torch.models import attention, decode_step, init_cache

    dev = prompts.device
    B, L = prompts.shape[0], SERVE["max_len"]
    fill = L - 64
    cache = init_cache(cfg, B, L, cfg.dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    for kv in cache["A"]["attn"].values():       # [layers, B, S, Hkv, D]
        kv[:, :, :fill].normal_(generator=g)
    idx = torch.full((), fill, dtype=torch.int32, device=dev)
    tok = prompts[:, :1]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = decode_step(params, cache, tok, idx, cfg)
        idx += 1
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    ms_step = 1e3 * sec / steps
    print(f"decode at a nearly full cache ({fill} of {L} positions filled), "
          f"B={B}: {steps} steps in {sec:.3f} s: {ms_step:.3f} ms/step, "
          f"{B * steps / sec:.1f} tokens/s; launches {counts}")
    want = dict({k: 0 for k in counts}, flash_decode=cfg.num_layers * steps)
    if counts != want:
        raise AssertionError(f"long-context launches {counts}, expected "
                             f"{want}")
    decode_breakdown(params, cfg, cache, idx, tok, ms_step)

    def plain(q, k, v, length):
        B_, H, D = q.shape
        out = ref.flash_decode_ref(q.reshape(B_, k.shape[2], -1, D),
                                   k.transpose(1, 2), v.transpose(1, 2),
                                   length)
        return out.reshape(B_, H, -1)

    shares = []

    def plain_beside_k6(q, k, v, length):
        want = plain(q, k, v, length)
        shares.append(k6_within(ops.flash_decode_op(q, k, v, length), want,
                                cfg.dtype)[1])
        return want

    idx += 1
    with torch.no_grad():
        got, _ = decode_step(params, cache, tok, idx, cfg)
        attention.flash_decode_op = plain_beside_k6
        try:
            want_lg, _ = decode_step(params, cache, tok, idx, cfg)
        finally:
            attention.flash_decode_op = ops.flash_decode_op
    got, want_lg = got.float(), want_lg.float()
    scale = float(want_lg.abs().max())
    err = float((got - want_lg).abs().max()) / scale
    agree = float((got[..., :cfg.vocab_size].argmax(-1)
                   == want_lg[..., :cfg.vocab_size].argmax(-1))
                  .float().mean())
    print(f"decode step at position {int(idx)} through K6 vs its plain "
          f"version: max |diff| {err:.3e} of max |logit| {scale:.3f} (<= "
          f"{SERVE_LOGIT_TOL}); argmax agreement {agree:.4f}; each "
          f"layer's K6 output vs plain on the same inputs: largest share "
          f"of the bound {max(shares):.3f} over {len(shares)} layers")
    if not bool(torch.isfinite(got).all()) or err > SERVE_LOGIT_TOL \
            or len(shares) != cfg.num_layers or max(shares) > 1.0:
        raise AssertionError("the long-context decode step through K6 "
                             "disagrees with its plain version")
    del cache
    torch.cuda.empty_cache()


def alternate_lengths(params, cfg, prompts, steps=16, turns=3):
    """Host-clock ms a decode step at a short context (positions 16 on)
    and at a nearly full cache (4032 on), in turns — short, full, short,
    ... — ``turns`` of each in one process, the same work a step at both
    (a fixed token, no sampling); prints every turn and the medians."""
    import torch
    from repro_torch.models import decode_step, init_cache

    dev = prompts.device
    B, L = prompts.shape[0], SERVE["max_len"]
    g = torch.Generator(device=dev).manual_seed(3)
    caches = {}
    for name, fill in (("short", 16), ("full", L - 64)):
        cache = init_cache(cfg, B, L, cfg.dtype, device=dev)
        for kv in cache["A"]["attn"].values():   # [layers, B, S, Hkv, D]
            kv[:, :, :fill].normal_(generator=g)
        caches[name] = (cache, fill)
    tok = prompts[:, :1]
    times = {"short": [], "full": []}
    with torch.no_grad():
        for _ in range(turns):
            for name, (cache, fill) in caches.items():
                idx = torch.full((), fill, dtype=torch.int32, device=dev)
                decode_step(params, cache, tok, idx, cfg)     # warm
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    idx += 1
                    decode_step(params, cache, tok, idx, cfg)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0) / steps)
    med = {name: statistics.median(v) for name, v in times.items()}
    print(f"decode in turns ({turns} of each, {steps} steps a turn, B={B}): "
          f"ms/step short {[round(x, 3) for x in times['short']]}, full "
          f"{[round(x, 3) for x in times['full']]}; medians short "
          f"{med['short']:.3f}, full {med['full']:.3f} (full - short "
          f"{med['full'] - med['short']:.3f} ms)")
    del caches
    torch.cuda.empty_cache()
    return med


def serve_full_width(dev):
    """granite-3-8b at full width (random weights from a seed, cast to
    bf16 once): SERVE's prompts through ``greedy_generate`` with the
    launch counters zeroed just before and read just after; then one
    counted decode step; then teacher-forced decode logits against
    ``forward`` on the same tokens; then decode at a nearly full cache
    (:func:`serve_long_context`).  Returns the K6 launches of the serve
    run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model, param_count)
    from repro_torch.serve import cast_params, greedy_generate

    cfg = get_config(SERVE["arch"])
    t0 = time.perf_counter()
    params = init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    n_params = param_count(params)
    params = cast_params(params, cfg.dtype)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"{cfg.name}: {n_params} params, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.vocab_padded}), {cfg.dtype}; made and cast in "
          f"{time.perf_counter() - t0:.1f} s; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    B, P, gen = SERVE["B"], SERVE["prompt"], SERVE["gen"]
    prompts = torch.tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, P)), device=dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    res = greedy_generate(params, cfg, prompts, gen, SERVE["max_len"])
    counts = dict(LAUNCHES)
    steps = P + res.decode_steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms_step = 1e3 * res.decode_s / res.decode_steps
    print(f"serve B={B}: prefill {P} tokens in {res.prefill_s:.3f} s "
          f"({1e3 * res.prefill_s / P:.2f} ms/step); decode "
          f"{res.decode_steps} steps in {res.decode_s:.3f} s: "
          f"{ms_step:.3f} ms/step, "
          f"{B * res.decode_steps / res.decode_s:.1f} tokens/s; peak device "
          f"memory {peak:.2f} GiB; launches {counts}")
    want = dict({k: 0 for k in counts}, flash_decode=cfg.num_layers * steps)
    if counts != want:
        raise AssertionError(f"serve launches {counts}, expected {want}")
    toks = res.tokens
    if toks.shape != (B, gen) or not bool(((toks >= 0)
                                           & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generated ids out of range: {toks.shape}")
    print("sample token ids:", toks[0, :12].cpu().tolist())

    cache = init_cache(cfg, B, SERVE["max_len"], cfg.dtype, device=dev)
    decode_breakdown(params, cfg, cache,
                     torch.zeros((), dtype=torch.int32, device=dev),
                     prompts[:, :1], ms_step)
    del cache

    # one decode step, counted alone: 40 K6 launches
    seq = torch.cat([prompts, toks[:, :-1]], dim=1)          # [B, P+gen-1]
    cache = init_cache(cfg, B, SERVE["max_len"], cfg.dtype, device=dev)
    idx = torch.zeros((), dtype=torch.int32, device=dev)
    reset_launch_counts()
    lg, cache = decode_step(params, cache, seq[:, :1], idx, cfg)
    torch.cuda.synchronize()
    if LAUNCHES["flash_decode"] != cfg.num_layers:
        raise AssertionError(f"one decode step launched K6 "
                             f"{LAUNCHES['flash_decode']} times")
    # teacher-forced decode over the served tokens against forward
    outs = [lg[:, 0]]
    for t in range(1, seq.shape[1]):
        idx += 1
        lg, cache = decode_step(params, cache, seq[:, t:t + 1], idx, cfg)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1).float()
    with torch.no_grad():
        fwd = forward(params, {"tokens": seq}, cfg)[0].float()
    scale = float(fwd.abs().max())
    err = float((dec - fwd).abs().max()) / scale
    agree = float((dec[..., :cfg.vocab_size].argmax(-1)
                   == fwd[..., :cfg.vocab_size].argmax(-1)).float().mean())
    finite = bool(torch.isfinite(dec).all() and torch.isfinite(fwd).all())
    print(f"full-width decode vs forward on {seq.shape[1]} tokens x {B}: max "
          f"|diff| {err:.3e} of max |logit| {scale:.3f} (<= "
          f"{SERVE_LOGIT_TOL}); argmax agreement {agree:.4f}; finite "
          f"{finite}; greedy tokens vs forward argmax "
          f"{float((fwd[:, P - 1:, :cfg.vocab_size].argmax(-1) == toks).float().mean()):.4f}")
    if not finite or err > SERVE_LOGIT_TOL:
        raise AssertionError("full-width decode logits disagree with forward")
    del cache, lg, dec, fwd
    torch.cuda.empty_cache()
    serve_long_context(params, cfg, prompts)
    alternate_lengths(params, cfg, prompts, turns=DECODE_TURNS)
    del params
    torch.cuda.empty_cache()
    return counts["flash_decode"]


def wire_q():
    from repro_torch.core.quantize import MixedResolutionQuantizer
    return MixedResolutionQuantizer(MAIN["lam"], MAIN["b"])


def per_round(n):
    """The launch counts of a packed round that runs K1, K2 and K3 ``n``
    times each."""
    from repro_torch.kernels import LAUNCHES
    return {k: n if k in WIRE_KERNELS else 0 for k in LAUNCHES}


def add_counts(total, counts):
    for k in WIRE_KERNELS:
        total[k] = total.get(k, 0) + counts[k]


def cohorts(dev):
    """``cohort-wire`` as registered (K=20, cohorts of C=8, no channel)
    ``COHORT_ROUNDS`` rounds beside ``fused-wire`` from the same init,
    and the same scenario with C=20; all inside ``deterministic_cudnn``,
    so the same training gives the same bits.  A cohort round launches
    K1, K2 and K3 once a cohort (3 times: 8, 8 and 4 users padded to 8);
    C=20 is one cohort of all users, the vectorized step bit for bit.
    Prints each round's wall time and the params gap to ``fused-wire``
    (C < K trains under a vmap of 8 users, which rounds the deltas
    another way than one of 20).  Returns (launch counts, the cohort
    run's state, the init params)."""
    from _torch_parity import params_gap, run_mismatches
    from repro_torch.fl.loop import deterministic_cudnn
    from repro_torch.sim import get_scenario, make_engine

    ck, counts = Checks("cohorts"), {}
    fused = dataclasses.replace(get_scenario("fused-wire"), T=COHORT_ROUNDS,
                                eval_every=1)
    cohort = dataclasses.replace(get_scenario("cohort-wire"),
                                 T=COHORT_ROUNDS, eval_every=1)
    whole = dataclasses.replace(cohort, cohort_size=cohort.K)
    eng = make_engine(fused, wire_q(), None, device=dev)
    init = eng.params
    runs = {}
    with deterministic_cudnn():
        for label, scn, n in (("fused-wire", fused, 1),
                              ("cohort-wire C=8", cohort, 3),
                              ("cohort-wire C=20", whole, 1)):
            if label != "fused-wire":
                eng = make_engine(scn, wire_q(), None, device=dev,
                                  init_params=init)
            c, state = drive(eng, COHORT_ROUNDS, per_round(n), label)
            add_counts(counts, c)
            runs[label] = eng.result(state)
    cohort_stages(dev, cohort, init)
    gap = params_gap(runs["cohort-wire C=8"].params, runs["fused-wire"].params)
    move = max(float(v.double().abs().max()) for v in init.values())
    print(f"  params gap cohort-wire C=8 to fused-wire after {COHORT_ROUNDS} "
          f"rounds: {gap:.3e} (params up to {move:.3e})")
    bad = run_mismatches(runs["cohort-wire C=20"], runs["fused-wire"])
    ck.true("C=20 (one cohort of all 20 users) bit for bit fused-wire",
            not bad, str(bad[:4]))
    ck.done()
    return counts, runs["cohort-wire C=8"], init


def cohort_stages(dev, scn, init, rounds=2):
    """Where a cohort round's time goes: ``rounds`` more rounds of
    ``scn`` with the cohort step's stages closed by a synchronize each
    (host clock, seconds a round): the cohorts' training (vmap), their
    encodes (pad, K1, epilogue, K2) and their folds (K3 with acc)."""
    from repro_torch.sim import VectorizedFLEngine, make_engine
    from repro_torch.sim import engine as engine_mod

    eng = make_engine(scn, wire_q(), None, device=dev, init_params=init)
    state = eng.start_run()
    eng.train_round(state, 1)
    times = {}
    with patched([
            (VectorizedFLEngine, "_batched_local",
             stopwatch(times, "training (vmap over a cohort)")),
            (engine_mod, "mixed_res_encode",
             stopwatch(times, "encode (pad, K1, epilogue, K2)")),
            (engine_mod, "mixed_res_wire_reduce",
             stopwatch(times, "fold (K3 with acc)"))]):
        for t in range(2, rounds + 2):
            eng.train_round(state, t)
    for label, secs in times.items():
        print(f"  {label}: {sum(secs) / rounds:.6f} s a round "
              f"({len(secs) // rounds} calls a round)")


def cohort_fold(dev):
    """The fold on the card, on given deltas: the main shape's U=40 users
    (d=462,410, user 1 all zero, user 3 at weight 0 as if churned)
    encoded and folded in chunks of C in {1, 8, 13, 40} through K3's
    ``acc`` (``_torch_parity.fold_chunks``); each must equal the
    one-shot K3 over all 40 users as values and give the same headers."""
    import torch
    from _torch_parity import bits_equal, fold_chunks
    from repro_torch.kernels import ops

    U, d, b, lam = MAIN["U"], MAIN["d"], MAIN["b"], MAIN["lam"]
    x = deltas(U, d, seed=11, device=dev)
    w = torch.rand(U, generator=torch.Generator(device=dev).manual_seed(5),
                   device=dev) / U
    w[3] = 0.0
    wire = ops.mixed_res_encode(x, lam, b)
    one = ops.mixed_res_wire_reduce(wire, w, b, d)
    ck = Checks("cohort fold")
    for C in COHORT_FOLD_CHUNKS:
        acc, head = fold_chunks(x, w, lam, b, C)
        torch.cuda.synchronize()
        ck.true(f"C={C}: {-(-U // C)} chunks folded through acc equal the "
                "one-shot K3 (values), headers bit for bit",
                torch.equal(acc, one) and bits_equal(head, wire.head),
                f"max |diff| {float((acc - one).abs().max()):.3e}")
    ck.done()


def cohort_hierarchy(dev, init, flat_run):
    """``cohort-hierarchy`` (4 AP clusters of 5 users, cohorts of 8)
    ``COHORT_ROUNDS`` rounds from the cohort phase's init: a cluster is
    one cohort (5 users padded to 8), so K1, K2 and K3 launch 4 times a
    round; the partials add in cluster order.  Bits bit for bit
    ``cohort-wire``'s, params within 1e-4 of them (f32 roundoff of the
    reassociated fold).  Returns the launch counts."""
    import numpy as np
    from _torch_parity import params_gap
    from repro_torch.fl.loop import deterministic_cudnn
    from repro_torch.sim import get_scenario, make_engine

    scn = dataclasses.replace(get_scenario("cohort-hierarchy"),
                              T=COHORT_ROUNDS, eval_every=1)
    eng = make_engine(scn, wire_q(), None, device=dev, init_params=init)
    with deterministic_cudnn():
        counts, state = drive(eng, COHORT_ROUNDS, per_round(4),
                              "cohort-hierarchy")
    ck = Checks("cohort-hierarchy")
    ck.true("bits bit for bit cohort-wire's in every round", all(
        np.array_equal(a.bits_per_user, b.bits_per_user)
        for a, b in zip(state.logs, flat_run.logs, strict=True)))
    ck.at_most("params gap to cohort-wire", params_gap(state.params,
                                                        flat_run.params),
               1e-4)
    ck.done()
    return {k: counts[k] for k in WIRE_KERNELS}


def scale_engine(K, C, dev):
    """The paper CNN at full width with one sample a user, L=1 and batch
    1 (``benchmarks/cohort_scale.py``'s data shape), no channel; cohorts
    of C on the packed plane, or the vectorized step when C is None."""
    import numpy as np
    from repro_torch.configs.paper_cnn import CIFAR10
    from repro_torch.data import make_image_classification
    from repro_torch.fl.loop import FLConfig
    from repro_torch.kernels import WirePath
    from repro_torch.sim import EngineConfig, VectorizedFLEngine

    ds = make_image_classification(n_samples=K + 200, hw=32, seed=0)
    train = dataclasses.replace(ds, x=ds.x[:K], y=ds.y[:K])
    test = dataclasses.replace(ds, x=ds.x[K:], y=ds.y[K:])
    return VectorizedFLEngine(
        train, test, [np.array([i]) for i in range(K)], CIFAR10, wire_q(),
        None, None, FLConfig(T=1, L=1, batch_size=1, seed=0, eval_every=1),
        engine=EngineConfig(wire=WirePath(plane="packed", cohort_size=C)),
        device=dev)


def cohort_scale(dev):
    """K = 2,000 and 20,000 users (cohorts of 256) and the vectorized
    step at K = 2,000: one round each after a warm-up round, its wall
    time (closed by a synchronize) and the round's peak device memory
    (``torch.cuda.max_memory_allocated``, and above what was allocated
    before the round) beside K*d*4 and C*d*4.  The cohort peak should
    track C, not K.  Returns the launch counts of the timed rounds."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts

    counts, peaks = {k: 0 for k in WIRE_KERNELS}, {}
    for K, C in SCALE_POINTS:
        eng = scale_engine(K, C, dev)
        d = eng.d
        state = eng.start_run()
        eng.train_round(state, 1)                    # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        work = eng.train_round(state, 2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        add_counts(counts, LAUNCHES)
        n = -(-K // C) if C else 1
        if any(LAUNCHES[k] != n for k in WIRE_KERNELS):
            raise AssertionError(f"K={K} C={C}: launches {dict(LAUNCHES)}, "
                                 f"expected {n} of K1, K2, K3")
        if not np.all(np.isfinite(work.bits_np)) or not all(
                bool(torch.isfinite(v).all()) for v in state.params.values()):
            raise AssertionError(f"K={K} C={C}: non-finite bits or params")
        label = f"K={K} " + (f"C={C}" if C else "vectorized")
        peaks[label] = peak - base
        print(f"{label}: round {wall:.3f} s, peak {peak / 1e9:.3f} GB "
              f"({(peak - base) / 1e9:.3f} GB above the "
              f"{base / 1e9:.3f} GB held before the round); K*d*4 = "
              f"{K * d * 4 / 1e9:.2f} GB, C*d*4 = "
              f"{(C or K) * d * 4 / 1e9:.2f} GB; mean bits "
              f"{work.bits_np.mean():.1f}; {n} cohorts")
        del eng, state, work
        torch.cuda.empty_cache()
    small, big = (peaks[f"K={K} C={C}"] for K, C in SCALE_POINTS[:2])
    print(f"  cohort peak above the held memory at K=20,000 / at K=2,000: "
          f"{big / small:.3f} ({'tracks C' if big <= 1.25 * small else 'grows with K'})")
    return counts


def layer_budget(dev, init):
    """``layer-budget-wire`` (norm leaves lambda 0.1, b 12; matmul leaves
    lambda 0.3, b 6): first K1-K3 against their plain versions bit for
    bit at U=20 and each of the paper CNN's six segment shapes with that
    segment's lambda and b, with and without ``acc``, K2 on both rules;
    then ``BUDGET_ROUNDS`` rounds, 6 launches each of K1, K2, K3 a
    round, every launch held to its plain version on its inputs
    (``WireSpy``); the per-segment bits identity on one more round's
    deltas; and a uniform budget bit for bit ``fused-wire`` over one
    round.  Returns the launch counts of the rounds."""
    import numpy as np
    import torch
    from _torch_parity import (WireSpy, run_mismatches,
                               segment_bits_identity)
    from repro_torch.core.quantize import LayerBudget
    from repro_torch.fl.loop import deterministic_cudnn
    from repro_torch.kernels import ops
    from repro_torch.sim import get_scenario, make_engine

    scn = dataclasses.replace(get_scenario("layer-budget-wire"),
                              T=BUDGET_ROUNDS, eval_every=1)
    eng = make_engine(scn, wire_q(), None, device=dev, init_params=init)
    segs = eng._segments
    print("segments: " + "; ".join(
        f"{s.group} [{s.start}, {s.stop}) lam {s.lambda_} b {s.b}"
        for s in segs))
    n_case = 0
    for seg in segs:
        for with_acc in (False, True):
            check_kernels(dev, scn.K, seg.size, seg.lambda_, seg.b, with_acc)
            n_case += 1
    print(f"K1-K3 at the {len(segs)} segment shapes (U={scn.K}, W from "
          f"{min(-(-s.size // 128) for s in segs)} to "
          f"{max(ops.sign_pad_len(s.size) // 128 for s in segs)}): {n_case} "
          "cases bit-exact, K2 on both rules")
    with WireSpy() as spy:
        counts, state = drive(eng, BUDGET_ROUNDS, per_round(len(segs)),
                              "layer-budget-wire")
    held = spy.check(np.zeros(scn.K))
    print(f"  every launch of the rounds bit for bit its plain version: "
          f"{held}")
    xs, ys = eng.draw_minibatches(state)
    with torch.no_grad():
        flat = eng._batched_local(state.params, xs, ys)
        _, bits, aux = ops.segmented_wire_aggregate(flat, eng._weights, segs)
        heads = [ops.mixed_res_encode(flat[:, s.start:s.stop], s.lambda_,
                                      s.b).head for s in segs]
    segment_bits_identity(bits, aux["segment_bits"], heads, segs)
    w = eng._weights
    for label, fn in (("the six segments", lambda: ops.segmented_wire_aggregate(
            flat, w, segs)), ("one global segment", lambda:
            ops.mixed_res_wire_aggregate(flat, w, MAIN["lam"], MAIN["b"]))):
        ks = device_kernels(fn, 10)
        by_name = {}
        for k, (n, us) in ks.items():
            name = k.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0][:32]
            by_name[name] = round(by_name.get(name, 0.0) + n * us, 2)
        print(f"  encode + reduce of U={scn.K} users' deltas over {label}: "
              f"{device_us(ks):.2f} us on the device; by kernel {by_name}")
    print("  bits = sum over segments of d_seg (b_seg s_seg + 1 - s_seg) + "
          f"32 on one more round's deltas: ok (mean bits "
          f"{float(bits.double().mean()):.1f})")
    uni = dataclasses.replace(get_scenario("fused-wire"), T=1, eval_every=1)
    runs = []
    with deterministic_cudnn():
        for budget in (None, LayerBudget.uniform()):
            e = make_engine(dataclasses.replace(uni, budget=budget), wire_q(),
                            None, device=dev, init_params=init)
            runs.append(e.run())
    bad = run_mismatches(runs[1], runs[0])
    ck = Checks("layer budget")
    ck.true("LayerBudget.uniform() bit for bit fused-wire", not bad,
            str(bad[:4]))
    ck.done()
    return {k: counts[k] for k in WIRE_KERNELS}



def async_rounds(dev):
    """Async rounds at K=20 over ``paper-table3``'s kind of channel
    (M=16, N=4), mixed-resolution(0.2, 10) under bisection-LP:
    ``async-q50`` on the dense plane as registered and on the packed
    plane (``async-q50-wire``), ``ASYNC_ROUNDS`` rounds each through
    ``run_cell`` (the host solve) and through ``run_grid_batched``;
    ``async-churn`` through ``run_cell``.  On the packed plane a round
    launches K1 and K2 once (the fresh uploads) and K3 once over 2K = 40
    slots (fresh and buffered planes), each launch held bit for bit to
    its plain version on its inputs (``WireSpy``).  ``async-q50-wire``
    with R = 2 replicates through ``run_grid_batched``: K1-K3 once a
    replicate a round, replicate 0 bit for bit the unreplicated run.
    Then ``async-sync-reduction`` bit for bit the lockstep run over
    ``SYNC_ROUNDS`` rounds in both drivers (inside
    ``deterministic_cudnn``).  Prints each run's wall time a round, mean
    staleness and dropped uploads.  Returns the launch counts."""
    import numpy as np
    import torch
    from _torch_parity import WireSpy, run_mismatches
    from repro_torch.fl.loop import deterministic_cudnn
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.sim import get_scenario, run_cell, run_grid_batched

    q = ("mixed-resolution", {"lambda_": MAIN["lam"], "b": MAIN["b"]})
    ck, counts = Checks("async"), {k: 0 for k in WIRE_KERNELS}
    for name in ("async-q50", "async-q50-wire", "async-churn"):
        scn = dataclasses.replace(get_scenario(name), T=ASYNC_ROUNDS,
                                  eval_every=1)
        drivers = (("run_cell", lambda: [run_cell(
            scn, q, "bisection-lp", quick=False, device=dev)]),)
        if name != "async-churn":
            drivers += (("run_grid_batched", lambda: run_grid_batched(
                [scn], {"mixed": q}, {"bisection-lp": "bisection-lp"},
                quick=False, device=dev)),)
        for driver, fn in drivers:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            with WireSpy() as spy:
                res = fn()[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            held = spy.check(np.zeros(2 * scn.K))
            logs = res.result.logs
            packed = scn.aggregation == "wire"
            want = ASYNC_ROUNDS if packed else 0
            ck.true(f"{name} / {driver}: {len(logs)} rounds, K1, K2, K3 "
                    f"{want} launches each, all bit for bit their plain "
                    "versions (K3 over 2K = 40 slots)",
                    len(logs) == ASYNC_ROUNDS
                    and all(LAUNCHES[k] == want for k in WIRE_KERNELS),
                    f"{held}")
            add_counts(counts, LAUNCHES)
            vals = [v for l in logs for v in (l.uplink_latency_s,
                                              l.test_acc, l.mean_staleness)]
            ck.true(f"{name} / {driver}: finite logs and params",
                    all(math.isfinite(v) for v in vals) and all(
                        bool(torch.isfinite(v).all())
                        for v in res.result.params.values()))
            print(f"{name} / {driver}: {wall / ASYNC_ROUNDS:.3f} s a round "
                  f"(setup included), event-clock uplinks "
                  f"{[round(l.uplink_latency_s, 6) for l in logs]}, mean "
                  f"staleness {res.summary['mean_staleness']:.4f}, "
                  f"dropped uploads {sum(l.dropped_uploads for l in logs)}, "
                  f"effective participation "
                  f"{res.summary['effective_participation']:.3f}")
    # the replicate axis on the packed plane loops the replicates
    wire = dataclasses.replace(get_scenario("async-q50-wire"),
                               T=ASYNC_ROUNDS, eval_every=1)
    grid = lambda R: run_grid_batched(
        [wire], {"mixed": q}, {"bisection-lp": "bisection-lp"},
        quick=False, device=dev, replicates=R)[0].result
    with deterministic_cudnn():
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        with WireSpy() as spy:
            rep = grid(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        held = spy.check(np.zeros(2 * wire.K))
        want = 2 * ASYNC_ROUNDS
        ck.true(f"async-q50-wire / run_grid_batched, R=2: K1, K2, K3 "
                f"{want} launches each, all bit for bit their plain "
                "versions", all(LAUNCHES[k] == want for k in WIRE_KERNELS),
                f"{held}")
        add_counts(counts, LAUNCHES)
        one = grid(None)
    bad = run_mismatches(rep[0], one)
    ck.true("async-q50-wire, R=2: replicate 0 bit for bit the "
            "unreplicated run", not bad, str(bad[:4]))
    ck.true("async-q50-wire, R=2: replicate 1 another trajectory",
            bool(run_mismatches(rep[1], one)))
    print(f"async-q50-wire / run_grid_batched, R=2: "
          f"{wall / ASYNC_ROUNDS:.3f} s a round (setup included)")
    sync = dataclasses.replace(get_scenario("async-sync-reduction"),
                               T=SYNC_ROUNDS, eval_every=1)
    lock = dataclasses.replace(sync, async_mode=False)
    with deterministic_cudnn():
        for driver, fn in (
                ("run_cell", lambda s: run_cell(s, q, "bisection-lp",
                                                quick=False, device=dev)),
                ("run_grid_batched", lambda s: run_grid_batched(
                    [s], {"mixed": q}, {"bisection-lp": "bisection-lp"},
                    quick=False, device=dev)[0])):
            bad = run_mismatches(fn(sync).result, fn(lock).result)
            ck.true(f"async-sync-reduction bit for bit the lockstep run "
                    f"over {SYNC_ROUNDS} rounds ({driver})", not bad,
                    str(bad[:4]))
    ck.done()
    return counts


NEW_PHASES = ("cohorts", "fold", "hierarchy", "scale", "budget", "async")


def user_axis_and_round_modes(dev, launches, only=NEW_PHASES):
    """The streaming cohorts, AP clusters, the cohort scale, per-layer
    budgets and async rounds, each phase's K1-K3 launches added into
    ``launches``.  ``only`` names the phases of :data:`NEW_PHASES` to
    run (all of them on the main path); a failed check raises."""
    init = cohort_run = None
    if "cohorts" in only or "hierarchy" in only or "budget" in only:
        phase(f"cohorts: cohort-wire (K=20, C=8) and C=20 beside fused-wire, "
              f"{COHORT_ROUNDS} rounds each")
        counts, cohort_run, init = cohorts(dev)
        add_counts(launches, counts)
    if "fold" in only:
        phase(f"cohort fold on the card: U={MAIN['U']} users in chunks of "
              f"{COHORT_FOLD_CHUNKS} through K3's acc")
        cohort_fold(dev)
    if "hierarchy" in only:
        phase(f"cohort-hierarchy (4 AP clusters, C=8): {COHORT_ROUNDS} rounds")
        add_counts(launches, cohort_hierarchy(dev, init, cohort_run))
    if "scale" in only:
        phase(f"cohort scale: the paper CNN, one sample a user, at "
              f"{SCALE_POINTS} (K, C)")
        add_counts(launches, cohort_scale(dev))
    if "budget" in only:
        phase(f"layer-budget-wire: the segment shapes, {BUDGET_ROUNDS} rounds")
        add_counts(launches, layer_budget(dev, init))
    if "async" in only:
        phase(f"async rounds: async-q50 (dense, packed), async-churn, "
              f"{ASYNC_ROUNDS} rounds; async-sync-reduction")
        add_counts(launches, async_rounds(dev))


def build_all():
    """Build every kernel source at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import mixed_res as mr, quant_pack as qp

    from repro_torch.kernels import flash_decode as fd

    with ThreadPoolExecutor(3) as pool:
        infos = list(pool.map(lambda m: m.build_info(), (mr, qp, fd)))
    for info in infos:
        print(f"built {info.path.name} in {info.seconds:.2f} s")
        for line in info.log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print("  " + line.strip())


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.core.quantize import MixedResolutionQuantizer
    from repro_torch.kernels import mixed_res as mr, quant_pack as qp, ref
    from repro_torch.sim import get_scenario, make_engine

    dev = torch.device("cuda")
    phase("device")
    card = card_line()
    print(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul_precision={torch.get_float32_matmul_precision()}")
    mem_rate, f32_rate = peaks(card.split(",")[0])

    phase("build")
    build_all()

    phase("kernels against their plain versions")
    U, d, b, lam = MAIN["U"], MAIN["d"], MAIN["b"], MAIN["lam"]
    errs, main_inputs = check_kernels(dev, U, d, lam, b, with_acc=False)
    print(f"K1-K3 main shapes U={U} W={main_inputs[0].shape[1]} d={d} "
          f"b={b} lam={lam}: bit-exact, errors {errs}")
    n_edge = 0
    for de in (3610, 65500):
        for be in (2, 4, 8, 10, 16):
            for le in (0.0, 0.2, 1.0):
                check_kernels(dev, 3, de, le, be, with_acc=(be % 4 == 0))
                n_edge += 1
    print(f"K1-K3 edge shapes: {n_edge} cases (W=29 masked, W=512 with "
          "d % 128 != 0, an all-zero user, b in {2,4,8,10,16}, "
          "lam in {0,0.2,1}, with and without acc; K2 on both rules) "
          "bit-exact")
    n_edge = 0
    for de, ue in ((3610, 5), (65500, 5), (16_777_000, 2)):
        for le in (0.0, 0.2, 1.0):
            for be in ((4, 10) if ue > 2 else (10,)):
                check_kernels(dev, ue, de, le, be, with_acc=False,
                              specials=True)
                n_edge += 1
    print(f"K1-K3 special values: {n_edge} cases (NaN, +-inf, "
          "+-subnormals, -0.0, an infinite max, a subnormal max, an "
          "all-zero user; W=29, W=512 and U=2 at d=16,777,000, most of "
          "each row beyond K1's staged tiles; lam in {0,0.2,1}; K2 on "
          "both rules) bit-exact")
    check_wire_graph_and_cutoffs(dev, *main_inputs[:2], lam, d, b)
    sign_errs, sign_inputs = check_sign_kernels(dev, U, d, edges=False)
    errs.update(sign_errs)
    print(f"K4-K5 main shapes G={U} rows={sign_inputs[1].shape[1]} d={d}: "
          f"bit-exact, errors {sign_errs}")
    n_edge = 0
    for de in (3610, 65500):
        for ge in (1, 3, U, 41, 257):
            check_sign_kernels(dev, ge, de, edges=True)
            n_edge += 1
    print(f"K4-K5 edge shapes: {n_edge} cases (W=29, W=512 with "
          "d % 128 != 0, G in {1,3,40,41,257}, zeros, -0.0, NaN, +-inf, "
          "+-subnormal, an all-zero plane) bit-exact")
    n_edge = check_k5(dev)
    print(f"K5 alone: {n_edge} cases (G in {K5_G} x W in {K5_W}; scales "
          f"{K5_SPECIAL_SCALES} rotated over G in (1, 2, 3, 40), -0.0 kept "
          "at G=1; 2 replays from one CUDA graph at G=40, W=3840) bit-exact")
    launched = check_many_users(dev)
    print(f"K1-K2 at U={MANY_USERS}, d=3610: bit-exact, (K1, K2) launches "
          f"{launched} over two calls each")
    narrow_reference_check(dev)

    phase("K6 flash-decode against its plain version")
    sv = K6_SERVE
    for dtype in ("bfloat16", "float32"):
        e, share = check_flash_decode(dev, sv["B"], sv["Hkv"], sv["G"],
                                      sv["S"], sv["D"], sv["Dv"], dtype,
                                      sv["S"])
        errs["K6"] = max(errs.get("K6", 0.0), e)
        print(f"K6 serve shape B={sv['B']} Hkv={sv['Hkv']} G={sv['G']} "
              f"S={sv['S']} D=Dv={sv['D']} {dtype}, full length: max abs "
              f"err {e:.3e}, {share:.3f} of the bound")
    n_edge, worst = 0, {}
    for dtype in ("float32", "bfloat16"):
        for (B, Hkv, G, S, D, Dv) in ((2, 8, 4, 4096, 128, 128),
                                      (1, 8, 5, 512, 128, 64),
                                      (2, 2, 8, 2048, 64, 64),
                                      (3, 8, 5, 1000, 128, 128),
                                      (1, 1, 1, 777, 64, 64)):
            for length in (1, 3, S - 17, S):
                e, share = check_flash_decode(dev, B, Hkv, G, S, D, Dv,
                                              dtype, length)
                prev = worst.get(dtype, (0.0, 0.0))
                worst[dtype] = (max(prev[0], e), max(prev[1], share))
                n_edge += 1
    print(f"K6 edge shapes: {n_edge} cases (f32 and bf16; D != Dv 128/64; "
          f"G in {{1,4,5,8}}; S in {{512,777,1000,2048,4096}}, S % 512 != 0 "
          f"included; length 1, 3, S-17, S) within tolerance; (max abs "
          f"err, largest share of the bound) {worst}")
    odd = {}
    for dtype in ("float32", "bfloat16"):       # D % 16 == 8: a half k-step
        for length in (1, 33, 283, 300):
            e, share = check_flash_decode(dev, 2, 2, 3, 300, 72, 64, dtype,
                                          length)
            odd[dtype] = max(odd.get(dtype, 0.0), share)
    print(f"K6 at D=72 (G=3, S=300, Dv=64; length 1, 33, 283, 300): largest "
          f"share of the bound {odd}")
    check_k6_graph_and_repeat(dev)
    narrow_decode_check(dev)

    phase("timing")
    x3, head, wire, w = main_inputs
    rows, words, scales = sign_inputs
    timed = {
        "K1": (lambda: mr.mixed_res_reduce(x3, lam, d),
               lambda: ref.mixed_res_reduce_ref(x3, lam, d)),
        "K2": (lambda: mr.mixed_res_emit(x3, head, b, d),
               lambda: ref.mixed_res_emit_ref(x3, head, b, d)),
        "K3": (lambda: mr.mixed_res_dequant_reduce(*wire, w, b),
               lambda: ref.mixed_res_dequant_reduce_ref(*wire, w, b)),
        "K4": (lambda: qp.signpack(rows), lambda: ref.signpack_ref(rows)),
        "K5": (lambda: qp.sign_dequant_reduce(words, scales),
               lambda: ref.sign_dequant_reduce_ref(words, scales)),
    }
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    planes = nbytes(wire.signs, wire.hi, wire.codes)
    red_out = x3.shape[1] * 128 * 4
    n_out = x3.shape[1] * 128
    work = {   # (bytes: each input read once, each output written once;
               #  operations)
        "K1": (nbytes(x3, head), OPS_PER_ELEMENT["K1"] * x3.numel()),
        "K2": (nbytes(x3, head) + planes,
               OPS_PER_ELEMENT["K2"] * x3.numel()),
        "K3": (planes + nbytes(head, w) + red_out,
               OPS_PER_ELEMENT["K3"] * x3.numel()),
        "K4": (nbytes(rows, words), OPS_PER_ELEMENT["K4"] * rows.numel()),
        "K5": (nbytes(words, scales) + red_out,
               OPS_PER_ELEMENT["K5"] * U * n_out),
    }
    rows_json = []
    for kid, (kern, plain) in timed.items():
        ms = time_ms(kern, 50)
        g_ms = graph_ms(kern, 50)
        k_us = device_us(device_kernels(kern, 50))
        plain_ms = time_ms(plain, 5)
        by, ops_ = work[kid]
        t_bytes, t_ops = by / mem_rate * 1e3, ops_ / f32_rate * 1e3
        rows_json.append({
            "name": f"{kid} {NAMES[kid]}", "route": "cuda",
            "source": SOURCES[kid], "replaces": REPLACES[kid],
            "launches": 0, "max_abs_err": errs[kid], "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": by, "library_ms": None, "graph_ms": g_ms,
            "kernel_us": k_us})
        print(f"{kid}: kernel {k_us:.2f} us on the device / {g_ms * 1e3:.2f} "
              f"us in a graph / {ms * 1e3:.2f} us eager, plain "
              f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.1f} us "
              f"({by / 1e6:.2f} MB), kernel at "
              f"{max(t_bytes, t_ops) * 1e3 / k_us:.3f} of it on {card}")
    time_encode(x3, lam, d, b, card, work["K2"][0] / mem_rate * 1e3)
    del x3, head, wire, w, main_inputs, rows, words, scales, sign_inputs
    k6_row = dict({"name": "K6 flash_decode", "route": "cuda",
                   "source": SOURCES["K6"], "replaces": REPLACES["K6"],
                   "launches": 0},
                  **time_flash_decode(dev, K6_SERVE, "bfloat16", card, 50,
                                      short=4))
    k6_row["max_abs_err"] = max(k6_row["max_abs_err"], errs["K6"])
    k6_row["decode_32k"] = time_flash_decode(dev, K6_DECODE_32K, "bfloat16",
                                             card, 10)
    rows_json.append(k6_row)

    q = MixedResolutionQuantizer(lam, b)
    table3 = get_scenario("paper-table3")
    engines = {}
    for plane, agg in (("packed", "wire"), ("signplane", "signplane")):
        scn = dataclasses.replace(table3, aggregation=agg, T=ROUNDS,
                                  eval_every=1)
        engines[plane] = make_engine(scn, q, "bisection-lp", device=dev)
        if engines[plane].d != d:
            raise AssertionError(f"d={engines[plane].d}, expected {d}")

    phase("three planes on the same full-width deltas")
    plane_agreement(engines["signplane"])

    none = {k: 0 for k in NAMES.values()}
    launches = {}
    phase(f"main path: {ROUNDS} rounds of paper-table3, packed wire")
    counts, state = drive(engines["packed"], ROUNDS, dict(
        none, mixed_res_reduce=1, mixed_res_emit=1,
        mixed_res_dequant_reduce=1), "packed")
    launches.update({k: counts[k] for k in ("mixed_res_reduce",
                                            "mixed_res_emit",
                                            "mixed_res_dequant_reduce")})
    phase(f"where packed round {ROUNDS + 1}'s time goes "
          "(after the counted run)")
    round_breakdown(engines["packed"], state)

    phase(f"main path: {ROUNDS} rounds of paper-table3, signplane")
    counts, state = drive(engines["signplane"], ROUNDS, dict(
        none, signpack=1, sign_dequant_reduce=1), "signplane")
    launches.update({k: counts[k] for k in ("signpack",
                                            "sign_dequant_reduce")})
    phase(f"where signplane round {ROUNDS + 1}'s time goes "
          "(after the counted run)")
    round_breakdown(engines["signplane"], state)
    del engines, state

    phase("paper-table3 as registered (dense plane), 1 round")
    scn = dataclasses.replace(table3, T=1, eval_every=1)
    if scn.engine_config().wire.plane != "dense":
        raise AssertionError("paper-table3 is registered on the dense plane")
    drive(make_engine(scn, q, "bisection-lp", device=dev), 1, none, "dense")

    phase(f"exact mode: {EXACT_ROUNDS} rounds of paper-table3 (K=40) "
          "against run_fl_sequential")
    exact_mode(dev)

    phase(f"churn-0.7 (K=20): {CHURN_ROUNDS} rounds each on the packed, "
          "signplane and dense (LAQ) planes")
    for counts in churn(dev).values():
        for k in ("mixed_res_reduce", "mixed_res_emit",
                  "mixed_res_dequant_reduce", "signpack",
                  "sign_dequant_reduce"):
            launches[k] += counts[k]

    phase("monte-carlo-channel (K=20): 3 rounds, a new channel a round")
    redraws(dev)

    phase(f"batched phy: the solvers on {PHY_REALIZATIONS} realizations of "
          "paper-table3's channel")
    phy_solvers(dev)
    phase(f"batched phy: run_grid_batched on paper-table3, packed, x "
          f"{len(PHY_POWERS)} power controllers, {PHY_ROUNDS} rounds")
    for k, v in phy_lockstep(dev).items():
        launches[k] += v
    phase(f"batched phy: replicates (monte-carlo-replicated R=8; R=1; R=2 "
          f"on the packed and signplane planes), {REPL_ROUNDS} rounds each")
    for k, v in phy_replicates(dev).items():
        launches[k] += v
    user_axis_and_round_modes(dev, launches)
    # what the phases leave in reference cycles (0.18-0.56 GiB on the
    # card) goes before the serve path's weights are made
    gc.collect()
    torch.cuda.empty_cache()

    phase("baselines: classic, top-q, LAQ, AQUILA; Dinkelbach, max-sum-rate")
    t0 = time.perf_counter()
    baselines(dev)
    print(f"baselines phase: {time.perf_counter() - t0:.2f} s")

    phase(f"serve path: full-width {SERVE['arch']}, B={SERVE['B']}, "
          f"prompt {SERVE['prompt']}, {SERVE['gen']} generated, cache "
          f"{SERVE['max_len']}")
    launches["flash_decode"] = serve_full_width(dev)

    for row in rows_json:
        row["launches"] = launches[row["name"].split()[1]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "main path")

    print(card)
    print(json.dumps({"kernels": rows_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

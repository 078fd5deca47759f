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
   shapes — planes, headers, sign words and the reduces bit for bit —
   and one narrow two-round run through the kernels against the same
   run on the CPU's plain path; K6 (flash-decode attention) at the
   serve shape (B=8, 8 kv heads, G=4, D=128, S=4096) and edge shapes,
   f32 within 1e-5 and bf16 within one bf16 ulp (``K6_TOL``), and a
   narrow reduced granite-3-8b decode through K6 against the same
   decode on the CPU;
4. times each kernel and its plain version with CUDA events, and K6
   beside ``scaled_dot_product_attention`` at the serve shape and at
   ``decode_32k``'s (B=128, S=32768, one layer's cache);
5. on one set of full-width deltas from the card, holds the signplane,
   dense and packed aggregates against each other, and the card's
   signplane aggregate against the CPU's;
6. drives the main paths at full width (``paper-table3``: K=40, the
   paper CNN, d=462,410, bisection-LP power control over M=16 APs with
   N=4 antennas), each with the launch counters zeroed just before and
   read just after: 3 rounds on the packed wire plane (K1–K3), 3 on the
   signplane plane (K4–K5), and 1 on the dense plane as registered;
   then a stage breakdown of one packed and one signplane round;
7. serves full-width granite-3-8b (random bf16 weights from a seed, 40
   layers): B=8 prompts of 16 tokens, 48 generated, a 4096-position
   cache, with the launch counters zeroed just before — 40 K6 launches
   a step — printing ms/step, tokens/s and peak memory, and holds
   teacher-forced decode logits against ``forward`` on the same tokens;
   then decodes at a nearly full cache (its first 4064 positions filled
   with random k/v), timing the steps and their device time by kernel,
   and holds one such step's logits through K6 against the same step
   with K6's plain version in its place;
8. prints one ``{"kernels": [...]}`` JSON line (K1–K6), and ends with
   ``{"ok": true, "device": {...}}``.

Exits non-zero, before printing any result, without a CUDA device or
without the repository's sources beside it.  Any failed check raises.
"""
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN = dict(U=40, d=462410, b=10, lam=0.2)
ROUNDS = 3
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


def phase(name):
    print(f"== {name}", flush=True)


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


def check_kernels(dev, U, d, lam, b, with_acc):
    """Every kernel against its plain version on one input; returns the
    largest error of each (0.0 for bit-identical outputs)."""
    import torch
    from repro_torch.kernels import WirePath, mixed_res as mr, ops, ref

    x3 = ops.wire_view(deltas(U, d, seed=d + b, device=dev)).contiguous()
    head_k = mr.mixed_res_reduce(x3, lam, d)
    head_p = ref.mixed_res_reduce_ref(x3, lam, d)
    wire_k = ops.mixed_res_encode(x3.reshape(U, -1)[:, :d], lam, b,
                                  path=WirePath(lowering="kernel"))
    head = wire_k.head
    planes_k = mr.mixed_res_emit(x3, head, b, d)
    planes_p = ref.mixed_res_emit_ref(x3, head, b, d)
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
                             f"b={b} acc={with_acc}: errors {errs}")
    return errs, (x3, head, wire_k, w)


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
        sign, bits, aux = eng.aggregate(flat)
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


def time_flash_decode(dev, shape, dtype, card, iters):
    """K6, its plain version and one ``scaled_dot_product_attention``
    call (flash backend, ``enable_gqa``) on the same inputs at full
    length; returns the timing row."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops, ref

    B, Hkv, G, S, D, Dv = (shape[k] for k in ("B", "Hkv", "G", "S", "D",
                                               "Dv"))
    dt = getattr(torch, dtype)
    q, k, v = kv_inputs(B, Hkv, G, S, D, Dv, dt, seed=7, device=dev)
    n = torch.tensor(S, dtype=torch.int32, device=dev)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)       # views, no copy
    got = ops.flash_decode_op(q, k, v, n)

    def plain():
        return ref.flash_decode_ref(q.reshape(B, Hkv, G, D), kt, vt, S)

    def library():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, enable_gqa=True)

    ms = time_ms(lambda: ops.flash_decode_op(q, k, v, n), iters)
    lib_ms = time_ms(library, iters)
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
    print(f"K6 at B={B} Hkv={Hkv} G={G} S={S} D={D} Dv={Dv} {dtype}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (flash, gqa) "
          f"{lib_ms:.4f} ms, bound {max(t_bytes, t_ops) * 1e3:.1f} us "
          f"({by / 1e6:.1f} MB); |K6 - plain| {err:.3e} ({share:.3f} of "
          f"the bound), |K6 - sdpa| {lib_err:.3e}; peak device memory with "
          f"the plain version {plain_peak:.2f} GiB on {card}")
    if share > 1.0:
        raise AssertionError(f"K6 disagrees with its plain version at the "
                             f"timed shape: {err}, {share:.2f} of the bound")
    return {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": by, "library_ms": lib_ms, "max_abs_err": err}


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
    del params
    torch.cuda.empty_cache()
    return counts["flash_decode"]


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
          "lam in {0,0.2,1}, with and without acc) bit-exact")
    sign_errs, sign_inputs = check_sign_kernels(dev, U, d, edges=False)
    errs.update(sign_errs)
    print(f"K4-K5 main shapes G={U} rows={sign_inputs[1].shape[1]} d={d}: "
          f"bit-exact, errors {sign_errs}")
    n_edge = 0
    for de in (3610, 65500):
        for ge in (1, 3, U):
            check_sign_kernels(dev, ge, de, edges=True)
            n_edge += 1
    print(f"K4-K5 edge shapes: {n_edge} cases (W=29, W=512 with "
          "d % 128 != 0, G in {1,3,40}, zeros, -0.0, NaN, +-inf, "
          "+-subnormal, an all-zero plane) bit-exact")
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
            "bytes": by, "library_ms": None})
        print(f"{kid}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops) * 1e3:.1f} us "
              f"({by / 1e6:.2f} MB) on {card}")
    del x3, head, wire, w, main_inputs, rows, words, scales, sign_inputs
    k6_row = dict({"name": "K6 flash_decode", "route": "cuda",
                   "source": SOURCES["K6"], "replaces": REPLACES["K6"],
                   "launches": 0},
                  **time_flash_decode(dev, K6_SERVE, "bfloat16", card, 50))
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
        none, mixed_res_reduce=2, mixed_res_emit=1,
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

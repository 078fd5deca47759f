#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and turns TF32 off for convolutions and matmuls;
2. builds the wire kernels K1–K3 from ``src/repro_torch/kernels/csrc``
   with nvcc, printing the build time and ptxas' register/spill lines;
3. holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes (U=40 users, W=3840 rows, d=462,410, b=10,
   lambda=0.2) and at edge shapes — planes, headers and the reduce bit
   for bit — and one narrow two-round run through the kernels against
   the same run on the CPU's plain path;
4. times each kernel and its plain version with CUDA events and prints
   one ``{"kernels": [...]}`` JSON line;
5. drives the main path: 3 rounds of ``paper-table3`` on the packed
   wire plane at full width (K=40, the paper CNN, d=462,410,
   bisection-LP power control over M=16 APs with N=4 antennas), with
   the launch counters zeroed just before and read just after;
6. ends with ``{"ok": true, "device": {...}}``.

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
# published peaks (NVIDIA data sheets): device memory bytes/s and dense
# f32 (non-tensor-core) operations/s, by the card's name
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12)}
# operations each kernel does per element of its input, counted from
# the source (abs, divide, compares, min/max, count; shifts and ORs for
# packing; per user: two products, an add, a select, the fold)
OPS_PER_ELEMENT = {"K1": 8, "K2": 12, "K3": 8}
REPLACES = {"K1": "src/repro/kernels/mixed_res.py:122",
            "K2": "src/repro/kernels/mixed_res.py:198",
            "K3": "src/repro/kernels/mixed_res.py:268"}
SOURCE = "src/repro_torch/kernels/csrc/mixed_res.cu"


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    for key, val in PEAKS.items():
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
    """Heavy-tailed f32 deltas, user 1 all zero, made on the card."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((U, d), generator=g, device=device)
    spikes = torch.randperm(d, generator=g, device=device)[:max(1, d // 64)]
    x[:, spikes] *= 50.0
    x[1] = 0.0
    return x


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


def round_breakdown(eng, state):
    """One more round, stage by stage, each closed by a synchronize:
    where a round's wall time goes (host clock, seconds)."""
    import numpy as np
    import torch
    from repro_torch.core.quantize.base import unflatten_pytree
    from repro_torch.kernels.ops import mixed_res_wire_aggregate

    q, out = eng.quantizer, {}

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
        agg, bits, _ = stage("wire encode + reduce (K1, K2, K3)",
                             lambda: mixed_res_wire_aggregate(
                                 flat, eng._weights, q.lambda_, q.b))
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core.quantize import MixedResolutionQuantizer
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.kernels import mixed_res as mr, ref
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
    info = mr.build_info()
    print(f"built {info.path.name} in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling")):
            print("  " + line.strip())

    phase("kernels against their plain versions")
    U, d, b, lam = MAIN["U"], MAIN["d"], MAIN["b"], MAIN["lam"]
    errs, main_inputs = check_kernels(dev, U, d, lam, b, with_acc=False)
    print(f"main shapes U={U} W={main_inputs[0].shape[1]} d={d} b={b} "
          f"lam={lam}: bit-exact, errors {errs}")
    n_edge = 0
    for de in (3610, 65500):
        for be in (2, 4, 8, 10, 16):
            for le in (0.0, 0.2, 1.0):
                check_kernels(dev, 3, de, le, be, with_acc=(be % 4 == 0))
                n_edge += 1
    print(f"edge shapes: {n_edge} cases (W=29 masked, W=512 with "
          "d % 128 != 0, an all-zero user, b in {2,4,8,10,16}, "
          "lam in {0,0.2,1}, with and without acc) bit-exact")
    narrow_reference_check(dev)

    phase("timing")
    x3, head, wire, w = main_inputs
    K1 = (lambda: mr.mixed_res_reduce(x3, lam, d),
          lambda: ref.mixed_res_reduce_ref(x3, lam, d))
    K2 = (lambda: mr.mixed_res_emit(x3, head, b, d),
          lambda: ref.mixed_res_emit_ref(x3, head, b, d))
    K3 = (lambda: mr.mixed_res_dequant_reduce(*wire, w, b),
          lambda: ref.mixed_res_dequant_reduce_ref(*wire, w, b))
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    planes = nbytes(wire.signs, wire.hi, wire.codes)
    red_out = x3.shape[1] * 128 * 4
    work = {   # (bytes: each input read once, each output written once;
               #  operations)
        "K1": (nbytes(x3, head), OPS_PER_ELEMENT["K1"] * x3.numel()),
        "K2": (nbytes(x3, head) + planes,
               OPS_PER_ELEMENT["K2"] * x3.numel()),
        "K3": (planes + nbytes(head, w) + red_out,
               OPS_PER_ELEMENT["K3"] * x3.numel()),
    }
    names = {"K1": "mixed_res_reduce", "K2": "mixed_res_emit",
             "K3": "mixed_res_dequant_reduce"}
    rows = []
    for kid, (kern, plain) in zip(("K1", "K2", "K3"), (K1, K2, K3)):
        ms = time_ms(kern, 50)
        plain_ms = time_ms(plain, 5)
        by, ops_ = work[kid]
        t_bytes, t_ops = by / mem_rate * 1e3, ops_ / f32_rate * 1e3
        rows.append({"name": f"{kid} {names[kid]}", "route": "cuda",
                     "source": SOURCE, "replaces": REPLACES[kid],
                     "launches": 0, "max_abs_err": errs[kid], "ms": ms,
                     "kernel_ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "bytes": by, "library_ms": None})
        print(f"{kid}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops) * 1e3:.1f} us "
              f"({by / 1e6:.1f} MB) on {card}")
    del x3, head, wire, w, main_inputs

    phase(f"main path: {ROUNDS} rounds of paper-table3, packed wire")
    scn = dataclasses.replace(get_scenario("paper-table3"),
                              aggregation="wire", T=ROUNDS, eval_every=1)
    eng = make_engine(scn, MixedResolutionQuantizer(lam, b), "bisection-lp",
                      device=dev)
    if eng.d != d:
        raise AssertionError(f"d={eng.d}, expected {d}")
    state = eng.start_run()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launch_counts()
    per_round = {"mixed_res_reduce": 2, "mixed_res_emit": 1,
                 "mixed_res_dequant_reduce": 1}
    for t in range(1, ROUNDS + 1):
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
        print(f"round {t}: mean bits {np.mean(log.bits_per_user):.1f}, "
              f"uplink {log.uplink_latency_s:.6f} s, cum latency "
              f"{log.cum_latency_s:.6f} s, acc {log.test_acc:.4f}, "
              f"mean s {log.mean_s:.5f}, wall {wall:.3f} s, "
              f"launches {delta}")
        if delta != per_round:
            raise AssertionError(f"round {t} launches {delta}, expected "
                                 f"{per_round}")
        vals = [log.uplink_latency_s, log.cum_latency_s, log.test_acc,
                log.mean_s, *log.bits_per_user]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"round {t}: non-finite log {log}")
        lo, hi = d + 32.0, b * d + 32.0
        if not np.all((log.bits_per_user >= lo) & (log.bits_per_user <= hi)):
            raise AssertionError(f"round {t}: bits outside [{lo}, {hi}]")
    counts = dict(LAUNCHES)
    for k, v in state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite params in {k}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB; launches over the {ROUNDS} rounds {counts}")
    phase(f"where round {ROUNDS + 1}'s time goes (after the counted run)")
    round_breakdown(eng, state)
    for row in rows:
        row["launches"] = counts[row["name"].split()[1]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "main path")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

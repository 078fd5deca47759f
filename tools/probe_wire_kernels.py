#!/usr/bin/env python3
"""Where K1 (``mixed_res_reduce``) and K2 (``mixed_res_emit``) spend their
time on the card: source variants timed beside the kernels as built.

    python3 tools/probe_wire_kernels.py

Needs a CUDA card and nvcc (as ``chip_smoke.py`` does).  Each variant is
``src/repro_torch/kernels/csrc/mixed_res.cu`` with one stretch of code
replaced (the replaced text must exist, or the script stops), built
into ``build/repro_torch/`` with the same flags, and launched through
the same C interface on the main path's deltas (U=40, d=462,410, b=10,
lambda=0.2).  Variants that skip work give wrong outputs; they measure
what the skipped work costs:

* K1 without phase 1 (phase 0 and both cluster barriers): the one read
  of x with the max, the barriers and the cutoff search;
* K1 without phase 1's second read of the streamed tiles (from L2);
* K2 with the threshold decided by one IEEE division an element, as
  before the cutoff;
* K2 with 4 rows in flight a warp and 128-row blocks;
* K2 walking the users first to last, timed right after K1 as the
  encode runs it (K2 walks them last to first to find in L2 the rows K1
  read last);

K1 as built at other cluster sizes and staging depths; and two library
calls as yardsticks of the card's read rate on the same x:
``torch.amax`` over each user (reads x once) and ``x.clone()`` (reads
and writes it).  Times are the profiler's device time a call, averaged
over 20 calls, each timed twice in turns.
"""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

U, D, B, LAM = 40, 462410, 10, 0.2
K1_PHASE1 = ("  walk<8>(mine, nf_buf, nf_all, fold_hi);\n"
             "  walk<4>(staged, 0, nf_buf, fold_hi);\n")
K1_REREAD = "  walk<8>(mine, nf_buf, nf_all, fold_hi);\n"
K2_CUT = "        const bool hb = in_cut(a, cut) && i < lim;\n"
K2_DIV = ("        const bool hb = (anchored ? a >= dwq\n"
          "            : __fdiv_rn(a, safe_den(h[H_INF])) >= h[H_LAM])\n"
          "            && i < lim;\n")
K2_SHAPE = ("constexpr int K2_RPW = 2;", "constexpr int K2_ROWS = 64;")
K2_LAST_FIRST = "  const int u = U - 1 - (int)blockIdx.y;\n"
K2_FIRST_LAST = "  const int u = (int)blockIdx.y;\n"
K1_CONFIGS = ((16, 4), (16, 9), (16, 14), (8, 7))
K2_WIDE = ("constexpr int K2_RPW = 4;", "constexpr int K2_ROWS = 128;")


def variant_sources(src):
    """{name: source text}; raises if a replaced stretch is missing."""
    def swap(text, old, new):
        if old not in text:
            raise RuntimeError(f"mixed_res.cu no longer holds {old!r}")
        return text.replace(old, new)

    wide = swap(swap(src, K2_SHAPE[0], K2_WIDE[0]), K2_SHAPE[1], K2_WIDE[1])
    return {"as built": src,
            "K1 without phase 1": swap(src, K1_PHASE1, ""),
            "K1 without phase 1's L2 re-read": swap(src, K1_REREAD, ""),
            "K2 threshold by division": swap(src, K2_CUT, K2_DIV),
            "K2 4 rows a warp, 128-row blocks": wide,
            "K2 users first to last": swap(src, K2_LAST_FIRST,
                                           K2_FIRST_LAST)}


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_wire_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch as L
    from repro_torch.kernels import mixed_res as mr
    from repro_torch.kernels import build, ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    src = (build.CSRC / "mixed_res.cu").read_text()
    libs = {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for i, (name, text) in enumerate(variant_sources(src).items()):
        path = build.BUILD_DIR / f"probe_mixed_res_{i}.cu"
        path.write_text(text)
        rel = pathlib.Path("..") / ".." / ".." / ".." / "build" / \
            "repro_torch" / path.name
        libs[name] = L.library(str(rel), "mr_error_string", mr._SIGNATURES)

    def dev_us(fn, calls=20, kernel=""):
        """Device us a call, of the kernels whose name holds ``kernel``."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and kernel in e.key) / calls

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((U, D), generator=g, device=dev)
    x[:, torch.randperm(D, generator=g, device=dev)[:D // 64]] *= 50.0
    x[1] = 0.0
    x3 = ops.wire_view(x).contiguous()
    W = x3.shape[1]
    head = ops.mixed_res_encode(x, LAM, B).head
    n, cap = mr._config_on(dev.index or 0, W)
    stats = torch.empty((U, 8), device=dev)
    planes = [torch.empty((U, W, w), dtype=torch.uint32, device=dev)
              for w in (4, 4, mr.code_words_per_row(B))]
    want_k1 = ref.mixed_res_reduce_ref(x3, LAM, D)
    want_k2 = ref.mixed_res_emit_ref(x3, head, B, D)

    def k1(lib, n=n, cap=cap):
        return lambda: L.launch(lib, "mr_reduce", x3.data_ptr(),
                                stats.data_ptr(), U, W, D, LAM, n, cap,
                                L.stream())

    def k2(lib):
        return lambda: L.launch(lib, "mr_emit", x3.data_ptr(),
                                head.data_ptr(),
                                *(p.data_ptr() for p in planes), U, W, D, B,
                                0, L.stream())

    def after_k1(lib):                # K2's share of a K1, K2 pair
        pair = lambda: (k1(libs["as built"])(), k2(lib)())
        return lambda: dev_us(pair, kernel="k2_emit")

    runs = {"K1 as built": k1(libs["as built"]),
            "K1 without phase 1": k1(libs["K1 without phase 1"]),
            "K1 without phase 1's L2 re-read":
                k1(libs["K1 without phase 1's L2 re-read"]),
            **{f"K1 at n={n_} cap={cap_} "
               f"{mr.reduce_occupancy(n_, cap_)}": k1(libs["as built"],
                                                     n_, cap_)
               for n_, cap_ in K1_CONFIGS},
            "K2 as built": k2(libs["as built"]),
            "K2 threshold by division": k2(libs["K2 threshold by division"]),
            "K2 4 rows a warp, 128-row blocks":
                k2(libs["K2 4 rows a warp, 128-row blocks"]),
            "torch.amax over each user (reads x)":
                lambda: torch.amax(x3, dim=(1, 2)),
            "x.clone() (reads and writes x)": lambda: x3.clone()}
    paired = {"K2 right after K1, users last to first (as built)":
                  after_k1(libs["as built"]),
              "K2 right after K1, users first to last":
                  after_k1(libs["K2 users first to last"])}
    times = {name: [] for name in (*runs, *paired)}
    for _ in range(2):
        for name, fn in runs.items():
            times[name].append(round(dev_us(fn), 2))
        for name, fn in paired.items():
            times[name].append(round(fn(), 2))
    runs["K1 as built"]()
    runs["K2 as built"]()
    exact = torch.equal(stats.view(torch.int32), want_k1.view(torch.int32)) \
        and all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(planes, want_k2))
    print(f"K1 as built at n={n} cap={cap} (clusters held, blocks an SM: "
          f"{mr.reduce_occupancy(n, cap)}); K1 and K2 as built bit-exact: "
          f"{exact}")
    for name, ts in times.items():
        print(f"{name}: {ts} us on the device")
    print(card)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())

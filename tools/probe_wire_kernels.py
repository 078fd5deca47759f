#!/usr/bin/env python3
"""Where the wire kernels K1 (``mixed_res_reduce``), K2 (``mixed_res_emit``)
and K5 (``sign_dequant_reduce``) spend their time on the card: source
variants timed beside the kernels as built.

    python3 tools/probe_wire_kernels.py [--only k1k2|k5]

Needs a CUDA card and nvcc (as ``chip_smoke.py`` does).

**K5** (``--only k5``): ``src/repro_torch/kernels/csrc/quant_pack.cu``
as built and at the other launches of ``K5_CONFIGS`` (lanes a row, rows
a block, stages in flight a warp), and three kernels appended to it:
K5's first port (one thread an output element, a 4-byte
broadcast load a peer, no unroll); the block-staged design the redesign
started from (a block of 16 rows stages 32 peers a stage between two
block barriers, 4 outputs a lane); and a simpler variant with no shared
memory (a warp a row loads its words straight from device memory, the
peer loop unrolled 8 deep, so 8 loads are in flight).  Each is held bit
for bit to the plain version and timed at G=40 peers of W=3840 rows
(the signplane round's shape), G=1, G=257 and G=1000, beside
``words.clone()`` as a yardstick of one pass over as many bytes.

**K1 and K2** (``--only k1k2``): each variant is
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
import argparse
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

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


# K5: the launches probed, (lanes a row, rows a block, stages in flight
# a warp), the built one among them; the shapes; and the kernels
# appended to every K5 variant
K5_CONFIGS = ((16, 2, 4), (16, 4, 4), (16, 8, 2), (16, 8, 4), (16, 8, 8),
              (16, 16, 4), (8, 8, 4), (32, 8, 4))
# K5's fold by a select and an add an output, in place of the add or
# subtract under a predicate
K5_FOLD = "    for (int i = 0; i < K5_OUT; ++i) a[i] = fold_bit(a[i], s, w & (1u << i));\n"
K5_FOLD_SELECT = ("    for (int i = 0; i < K5_OUT; ++i)\n"
                  "      a[i] = __fadd_rn(a[i], (w & (1u << i)) ? s : -s);\n")
K5_SHAPES = ((1, 3840), (40, 3840), (257, 3840), (1000, 3840))
K5_APPENDED = r"""
namespace {

// K5's first port: one thread an output element, the lanes of a
// warp sharing a word (a 4-byte broadcast load a peer), no unroll
__global__ void __launch_bounds__(256)
k5_per_element(const unsigned* __restrict__ words,
               const float* __restrict__ scales, float* __restrict__ out,
               int G, long long W) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= W * 128) return;
  const long long r = i >> 7;
  const int e = (int)(i & 127), c = e >> 5, j = e & 31;
  const unsigned* wr = words + r * 4 + c;
  float total = 0.0f;
  for (int g = 0; g < G; ++g) {
    const unsigned w = wr[(long long)g * W * 4];
    const float s = scales[g];
    const float val = ((w >> j) & 1u) ? s : -s;
    total = (g == 0) ? val : __fadd_rn(total, val);
  }
  out[i] = total;
}

// the design the port started from: a block of 16 rows, a warp a row,
// lane l owning outputs 4l..4l+3; the block stages 32 peers of its rows
// a stage (16 contiguous bytes a row a peer) with cp.async, double
// buffered between two block barriers a stage
constexpr int KB_ROWS = 16, KB_CHUNK = 32, KB_THREADS = KB_ROWS * 32;
__global__ void __launch_bounds__(KB_THREADS)
k5_block_staged(const uint4* __restrict__ words,
                const float* __restrict__ scales, float4* __restrict__ out,
                int G, long long W) {
  __shared__ uint4 stage[2][KB_CHUNK][KB_ROWS];
  __shared__ float scale[2][KB_CHUNK];
  const int t = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * KB_ROWS;
  const int chunks = (G + KB_CHUNK - 1) / KB_CHUNK;
  const int pg = t / KB_ROWS, pr = t % KB_ROWS;
  auto issue = [&](int k) {
    const int g = k * KB_CHUNK + pg, buf = k & 1;
    if (g < G && r0 + pr < W) {
      cp_async16(&stage[buf][pg][pr], words + (long long)g * W + r0 + pr);
    }
    if (t < KB_CHUNK && k * KB_CHUNK + t < G) {
      cp_async4(&scale[buf][t], scales + k * KB_CHUNK + t);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const int rr = t >> 5, lane = t & 31;
  const int c = lane >> 3, sh = 4 * (lane & 7);
  const bool mine = r0 + rr < W;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  auto term = [&](const unsigned* wp, const float* sp, int j, bool first) {
    const unsigned w = wp[j * KB_ROWS * 4] >> sh;
    const float s = sp[j];
    const float ns = first && s != s ? __uint_as_float(0x7fffffffu) : -s;
    const float v0 = (w & 1u) ? s : ns, v1 = (w & 2u) ? s : ns;
    const float v2 = (w & 4u) ? s : ns, v3 = (w & 8u) ? s : ns;
    if (first) {
      a0 = v0; a1 = v1; a2 = v2; a3 = v3;
    } else {
      a0 = __fadd_rn(a0, v0); a1 = __fadd_rn(a1, v1);
      a2 = __fadd_rn(a2, v2); a3 = __fadd_rn(a3, v3);
    }
  };
  issue(0);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (mine) {
      const int buf = k & 1, n = min(KB_CHUNK, G - k * KB_CHUNK);
      const unsigned* wp =
          reinterpret_cast<const unsigned*>(&stage[buf][0][rr]) + c;
      int j = 0;
      if (k == 0) term(wp, scale[buf], j++, true);
#pragma unroll 4
      for (; j < n; ++j) term(wp, scale[buf], j, false);
    }
    __syncthreads();
  }
  if (mine) out[(r0 + rr) * 32 + lane] = make_float4(a0, a1, a2, a3);
}

// no shared memory: a warp a row, lane l owning outputs 4l..4l+3, its
// word loaded straight from device memory, the peer loop unrolled 8
// deep (8 loads in flight)
constexpr int K5D_ROWS = 8;
__global__ void __launch_bounds__(K5D_ROWS * 32)
k5_direct(const unsigned* __restrict__ words,
          const float* __restrict__ scales, float4* __restrict__ out,
          int G, long long W) {
  const long long r = (long long)blockIdx.x * K5D_ROWS + (threadIdx.x >> 5);
  if (r >= W) return;
  const int lane = threadIdx.x & 31, sh = 4 * (lane & 7);
  const unsigned* wr = words + r * 4 + (lane >> 3);
  const long long stride = W * 4;
  float a0, a1, a2, a3;
  auto term = [&](unsigned w, float s, bool first) {
    w >>= sh;
    const float ns = -s;
    const float v0 = (w & 1u) ? s : ns, v1 = (w & 2u) ? s : ns;
    const float v2 = (w & 4u) ? s : ns, v3 = (w & 8u) ? s : ns;
    if (first) {
      a0 = v0; a1 = v1; a2 = v2; a3 = v3;
    } else {
      a0 = __fadd_rn(a0, v0); a1 = __fadd_rn(a1, v1);
      a2 = __fadd_rn(a2, v2); a3 = __fadd_rn(a3, v3);
    }
  };
  term(__ldg(wr), __ldg(scales), true);
  int g = 1;
  for (; g + 8 <= G; g += 8) {
    unsigned w[8];
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = __ldg(wr + (g + i) * stride);
      s[i] = __ldg(scales + g + i);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) term(w[i], s[i], false);
  }
  for (; g < G; ++g) term(__ldg(wr + g * stride), __ldg(scales + g), false);
  out[r * 32 + lane] = make_float4(a0, a1, a2, a3);
}

}  // namespace

extern "C" {

int probe_k5_per_element(const unsigned* words, const float* scales,
                         float* out, int G, long long W, void* stream) {
  const unsigned blocks = (unsigned)((W * 128 + 255) / 256);
  k5_per_element<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      words, scales, out, G, W);
  return (int)cudaGetLastError();
}

int probe_k5_block_staged(const unsigned* words, const float* scales,
                          float* out, int G, long long W, void* stream) {
  const unsigned blocks = (unsigned)((W + KB_ROWS - 1) / KB_ROWS);
  k5_block_staged<<<blocks, KB_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(words), scales,
      reinterpret_cast<float4*>(out), G, W);
  return (int)cudaGetLastError();
}

int probe_k5_direct(const unsigned* words, const float* scales, float* out,
                    int G, long long W, void* stream) {
  const unsigned blocks = (unsigned)((W + K5D_ROWS - 1) / K5D_ROWS);
  k5_direct<<<blocks, K5D_ROWS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      words, scales, reinterpret_cast<float4*>(out), G, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
"""


K5_NAMES = ("K5_LANES", "K5_ROWS", "K5_STAGES")


def k5_variant_sources(src, built):
    """{(lanes, rows, stages): quant_pack.cu at that launch, with the
    probe's kernels appended}; ``built`` is the source's own; raises if
    a constant's line is missing."""
    out = {}
    for config in K5_CONFIGS:
        text = src
        for name, old, new in zip(K5_NAMES, built, config):
            line = f"constexpr int {name} = {old}; "
            if line not in text:
                raise RuntimeError(f"quant_pack.cu no longer holds {line!r}")
            text = text.replace(line, f"constexpr int {name} = {new}; ")
        out[config] = text + K5_APPENDED
    if K5_FOLD not in src:
        raise RuntimeError(f"quant_pack.cu no longer holds {K5_FOLD!r}")
    out["fold by select"] = src.replace(K5_FOLD, K5_FOLD_SELECT) \
        + K5_APPENDED
    return out


def k5_built(src):
    """(lanes, rows, stages) as quant_pack.cu holds them."""
    import re
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src)[1])
                 for n in K5_NAMES)


def load_variant(name, text, error_fn, signatures):
    """Write ``text`` into the build directory as ``name`` and build and
    load it like a source under ``csrc/``."""
    from repro_torch.kernels import build
    from repro_torch.kernels import launch as L
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / name
    path.write_text(text)
    rel = pathlib.Path("..") / ".." / ".." / ".." / "build" / \
        "repro_torch" / path.name
    return L.library(str(rel), error_fn, signatures)


def dev_us(fn, calls=20, kernel="", tries=3):
    """Device us a call, of the kernels whose name holds ``kernel``; a
    profile that recorded no such kernel is taken again, up to ``tries``
    times, and then raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key)
        if us > 0:
            return us / calls
    raise RuntimeError(f"the profiler recorded no {kernel or 'device'} "
                       f"time in {tries} tries")


def probe_k5():
    """K5 as built, at its other launches and fold, and the three
    appended kernels: bit-exactness and device time at each shape."""
    import torch
    from repro_torch.kernels import launch as L
    from repro_torch.kernels import build, quant_pack as qp, ref

    sigs = qp._SIGNATURES + tuple(
        (name, (L.P, L.P, L.P, L.I, L.LL, L.P))
        for name in ("probe_k5_per_element", "probe_k5_direct",
                     "probe_k5_block_staged"))
    src = (build.CSRC / "quant_pack.cu").read_text()
    built = k5_built(src)
    variants = k5_variant_sources(src, built)
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(
            lambda kv: load_variant(
                "probe_quant_pack_{}.cu".format(
                    "_".join(map(str, kv[0])) if isinstance(kv[0], tuple)
                    else kv[0].replace(" ", "_")), kv[1],
                "qp_error_string", sigs),
            variants.items())))
    dev = torch.device("cuda")
    exact, times = True, {}
    for G, W in K5_SHAPES:
        g = torch.Generator(device=dev).manual_seed(G)
        words = torch.randint(-2 ** 31, 2 ** 31, (G, W, 4), generator=g,
                              dtype=torch.int64, device=dev) \
            .to(torch.int32).view(torch.uint32)
        scales = torch.rand(G, generator=g, device=dev) * 2 - 0.5
        out = torch.empty((W, 128), device=dev)
        want = ref.sign_dequant_reduce_ref(words, scales)
        args = (words.data_ptr(), scales.data_ptr(), out.data_ptr(), G, W)

        def planned(config):
            lanes, rows, _ = built if config == "fold by select" else config
            return lambda: L.launch(libs[config], "qp_sign_dequant_reduce",
                                    *args, rows, lanes, -(-W // rows),
                                    L.stream())

        runs = {**{"K5 at {} lanes a row, {} rows a block, {} stages"
                   .format(*cf) + (" (as built)" if cf == built else ""):
                   planned(cf) for cf in K5_CONFIGS},
                "K5 as built, its fold by a select and an add":
                    planned("fold by select"),
                "K5 block-staged (16 rows, 32 peers a stage, 4 outputs a "
                "lane, block barriers)": lambda: L.launch(
                    libs[built], "probe_k5_block_staged", *args,
                    L.stream()),
                "K5 no shared memory, 8 loads in flight": lambda: L.launch(
                    libs[built], "probe_k5_direct", *args, L.stream()),
                "K5 first port (a thread an element)":
                    lambda: L.launch(libs[built], "probe_k5_per_element",
                                     *args, L.stream()),
                "words.clone() (yardstick)": lambda: words.clone()}
        for name, fn in runs.items():
            if "clone" in name:
                continue
            out.fill_(float("nan"))
            fn()
            same = torch.equal(out.view(torch.int32), want.view(torch.int32))
            exact &= same
            print(f"G={G} W={W} {name}: bit-exact {same}")
        for _ in range(2):
            for name, fn in runs.items():
                times.setdefault((G, W, name), []).append(round(dev_us(fn),
                                                                2))
    for (G, W, name), ts in times.items():
        print(f"G={G} W={W} {name}: {ts} us on the device")
    print(f"K5 as built, instructions in its SASS by opcode: "
          f"{sass_opcodes(libs[built][1].path, 'k5_sign_dequant_reduce')}")
    return exact


def sass_opcodes(library, kernel):
    """{opcode: count} over the SASS of ``kernel`` in a built library
    (``cuobjdump -sass``; predicates such as ``@!P0`` dropped)."""
    import collections
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if inside and m:
            counts[m[2]] += 1
    return dict(counts.most_common(12))


def probe_k1_k2():
    """K1 and K2 as built, their source variants and other
    configurations of K1, with two library yardsticks."""
    import torch
    from repro_torch.kernels import launch as L
    from repro_torch.kernels import mixed_res as mr
    from repro_torch.kernels import build, ops, ref

    src = (build.CSRC / "mixed_res.cu").read_text()
    libs = {name: load_variant(f"probe_mixed_res_{i}.cu", text,
                               "mr_error_string", mr._SIGNATURES)
            for i, (name, text) in enumerate(variant_sources(src).items())}
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
    return exact


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("k1k2", "k5"))
    only = ap.parse_args().only
    import torch
    if not torch.cuda.is_available():
        print("probe_wire_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    exact = True
    if only != "k5":
        exact &= probe_k1_k2()
    if only != "k1k2":
        exact &= probe_k5()
    print(card)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())

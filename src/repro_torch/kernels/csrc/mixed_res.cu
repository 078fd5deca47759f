// Mixed-resolution wire kernels K1-K3 for Hopper (sm_90a), plain C
// interface for ctypes.  Each replaces a Pallas kernel of the JAX
// package (src/repro/kernels/mixed_res.py) and computes what its plain
// PyTorch version (src/repro_torch/kernels/ref.py) computes:
//
//   K1 mr_reduce          <- mixed_res_reduce (_reduce_kernel): pass A
//   K2 mr_emit            <- mixed_res_emit (_emit_kernel): pass B
//   K3 mr_dequant_reduce  <- mixed_res_dequant_reduce
//                            (_dequant_reduce_kernel): decode + reduce
//
// All three are bound by device memory: each reads its f32 input or
// packed planes once and does a handful of operations per element, far
// below the card's operations-per-byte balance.  K1 stages each user's
// row in the shared memory of a thread-block cluster, so it reads the
// row from device memory once for its two phases; K2 streams with
// 16-byte loads and several rows in flight a warp; K3 keeps every load
// coalesced and writes each output once.  Each note below says more.
//
// The threshold rule without a division.  The plain versions mark an
// element high resolution when fl(|x| / c) >= lam, c = safe(||x||_inf).
// A correctly rounded division is monotone in its numerator, so for a
// fixed finite c > 0 the set of |x| in [0, +inf] that passes is
// [t*, +inf], t* the least float that passes; K1 and K2 find t* once a
// user (threshold_cutoff: a warp tests 32 bit patterns a round, each
// with the same IEEE division) and then compare lo <= |x| <= hi.  For
// c = +inf (a user holding an infinite element) finite |x| give 0 and
// |x| = +inf gives NaN, so the set is [0, FLT_MAX] when 0 >= lam and
// empty otherwise; an empty set is (NaN, NaN).  NaN |x| never passes.
// ref.threshold_cutoff finds the same t* by bisection in numpy.
//
// Numerics: every divide is IEEE (__fdiv_rn), codes round half to even
// (rintf), and the build passes -fmad=false; K3 also spells each
// product and sum as __fmul_rn/__fadd_rn, so it folds the users in the
// plain version's order with the same roundings and agrees with it bit
// for bit.  Subnormals are kept (no ftz).
//
// Every entry point launches on the given stream, does not synchronise,
// and returns the launch's error: a refused launch (a cluster the card
// cannot place, too much shared memory) is an error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int H_INF = 0, H_DWQ = 1, H_STEP = 2, H_DBAR = 3, H_LAM = 4;
constexpr int HEADER_LANES = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned F32_INF_BITS = 0x7f800000u;
constexpr unsigned F32_MAX_BITS = 0x7f7fffffu;
constexpr unsigned F32_NAN_BITS = 0x7fc00000u;
constexpr unsigned F32_NAN_CANON_BITS = 0x7fffffffu;
constexpr unsigned ABS_MASK = 0x7fffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = 1 << 17;     // rows a user: 32-bit row arithmetic

__device__ __forceinline__ float safe_den(float v) {
  return (v > 0.0f) ? v : 1.0f;   // the jnp where(v > 0, v, 1.0), NaN -> 1
}

struct MaxOp { __device__ unsigned operator()(unsigned a, unsigned b) const { return max(a, b); } };
struct MinOp { __device__ unsigned operator()(unsigned a, unsigned b) const { return min(a, b); } };
struct AddOp { __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; } };

template <typename Op>
__device__ __forceinline__ unsigned warp_reduce(unsigned v, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Reduce one unsigned per thread over a block of NT threads; the result
// is valid in thread 0.  Every thread of the block must call it.
template <int NT, typename Op>
__device__ unsigned block_reduce(unsigned v, unsigned identity, Op op) {
  __shared__ unsigned partial[NT / 32];
  v = warp_reduce(v, op);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_reduce((lane < NT / 32) ? partial[lane] : identity, op);
  }
  __syncthreads();   // partial[] is reused by the next call
  return v;
}

// ------------------------------------------------------------- cutoff
// The high-resolution set {a : lo <= a <= hi} of fl(a / c) >= lam over
// a = |x|, c = safe_den(inf) (see the file's head).  Called by all 32
// lanes of a warp with the same (c, lam); every lane gets the result.
struct Cutoff { float lo, hi; };

__device__ __forceinline__ bool passes(unsigned bits, float c, float lam) {
  return __fdiv_rn(__uint_as_float(bits), c) >= lam;
}

__device__ Cutoff threshold_cutoff(float c, float lam) {
  const float nan = __uint_as_float(F32_NAN_BITS);
  const float inf = __uint_as_float(F32_INF_BITS);
  if (c == inf) {
    return (0.0f >= lam) ? Cutoff{0.0f, __uint_as_float(F32_MAX_BITS)}
                         : Cutoff{nan, nan};
  }
  if (!passes(F32_INF_BITS, c, lam)) return Cutoff{nan, nan};
  if (passes(0u, c, lam)) return Cutoff{0.0f, inf};
  // everything below lo fails, hi passes: the answer is in [lo, hi].
  // Round 0 tests the 32 patterns around fl(lam * c), where t* lies
  // unless a product or quotient leaves the normal range; each later
  // round tests 32 evenly spaced patterns and keeps a 1/32 of the span.
  const unsigned lane = threadIdx.x & 31;
  unsigned lo = 1u, hi = F32_INF_BITS;
  const unsigned guess = min(__float_as_uint(__fmul_rn(lam, c)), F32_INF_BITS);
  unsigned base = min(max(guess, lo + 15u) - 15u, hi), step = 1u;
  while (lo < hi) {
    const unsigned p = base + lane * step;
    const unsigned ball = __ballot_sync(FULL, p >= hi || passes(p, c, lam));
    if (ball == 0u) {
      lo = base + 31u * step + 1u;
    } else {
      const unsigned f = __ffs(ball) - 1u;
      if (f > 0u) lo = base + (f - 1u) * step + 1u;
      hi = min(hi, base + f * step);
    }
    base = lo;
    step = (hi - lo + 31u) / 32u;
  }
  return Cutoff{__uint_as_float(hi), inf};
}

__device__ __forceinline__ bool in_cut(float a, Cutoff c) {
  return a >= c.lo && a <= c.hi;
}

// ---------------------------------------------------------------- K1
// Replaces mixed_res_reduce (src/repro/kernels/mixed_res.py:122, body
// _reduce_kernel :84).  Bound: device memory, one read of x (U*W*512
// bytes) and 32 bytes a user out; the TPU kernel read x twice from
// device memory, once a phase, and so did the two launches that came
// before this design.
//
// One thread-block cluster of n blocks (up to 16) a user, grid (n, U).
// The user's 16-row tiles are shared evenly over the ranks, whole tiles
// each, so at small W most ranks own none.  Each rank copies its first
// `cap` tiles into its shared memory with 16-byte cp.async and streams
// the rest with 16-byte loads, eight a thread in flight, taking the max
// of |x|.  The ranks' maxes meet through distributed shared memory
// (publish, cluster.sync, each rank folds them); each rank's warp 0
// finds the cutoff, and phase 1 counts the high-resolution elements of
// the valid range and takes their min, from shared memory and, for the
// streamed tiles, again from L2, where the cluster read them
// microseconds before.  The ranks' (min, count) go to rank 0 by remote
// stores before a second cluster.sync; rank 0 writes all 8 header
// lanes.  No fill, no atomics, one launch.  Every block meets both
// cluster barriers, empty ones included, and no block touches a peer's
// shared memory after the second.
//
// The staging depth trades the L2 re-read against blocks an SM holds:
// the wrapper stages up to K1_STAGE_TILES (7) tiles, 56 KB, so three
// blocks share an SM.  Measured at the main shape (PERF.md): 1-D bulk
// copies with an mbarrier a tile were slower than cp.async, deeper
// staging (fewer blocks an SM) and persistent clusters that prefetch
// the next user were slower.
//
// Max and min run on the f32 bit patterns as unsigned: every operand is
// non-negative after the sign bit is cleared, where the unsigned order
// is the float order and a NaN (above +inf) stays the largest; a NaN
// max is written as the card's canonical NaN, as torch.amax gives it
// there.  The count is an exact integer (d < 2**24).

constexpr int K1_THREADS = 256;
constexpr int K1_MIN_BLOCKS = 3;                    // <= 85 registers a thread
constexpr int TILE_ROWS = 16;
constexpr int TILE_F4 = TILE_ROWS * 32;             // float4s in a tile
constexpr int K1_CLUSTER_MAX = 16;
constexpr int K1_CAP_MAX = 28;                      // staged tiles, 224 KB
constexpr int K1_HEAD_BYTES = 256;                  // K1Smem, padded

struct K1Smem {
  unsigned max_bits;                                // this rank's max
  unsigned min_bits[K1_CLUSTER_MAX];                // rank 0: every rank's
  unsigned count[K1_CLUSTER_MAX];
  Cutoff cut;
  unsigned inf_bits;
};
static_assert(sizeof(K1Smem) <= K1_HEAD_BYTES, "K1 header overflows");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(reinterpret_cast<unsigned long long>(src))
               : "memory");
}

// fold(v, f) over src[f] for f in [beg, end), the block's threads taking
// UNROLL float4s each a step, all loaded before any is folded
template <int UNROLL, typename Fold>
__device__ __forceinline__ void walk(const float4* src, int beg, int end,
                                     Fold&& fold) {
  for (int f = beg + (int)threadIdx.x; f < end; f += K1_THREADS * UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (f + j * K1_THREADS < end) v[j] = src[f + j * K1_THREADS];
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (f + j * K1_THREADS < end) fold(v[j], f + j * K1_THREADS);
    }
  }
}

__global__ void __launch_bounds__(K1_THREADS, K1_MIN_BLOCKS)
k1_reduce(const float4* __restrict__ x, float* __restrict__ head, int W,
          int d_valid, float lam, int cap) {
  extern __shared__ __align__(128) unsigned char k1_smem[];
  K1Smem& sh = *reinterpret_cast<K1Smem*>(k1_smem);
  float4* const staged = reinterpret_cast<float4*>(k1_smem + K1_HEAD_BYTES);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = static_cast<int>(cluster.num_blocks());
  const int u = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // this rank's tiles [t0, t0 + nt); its float4s are contiguous from
  // `mine`: [0, nf_buf) staged (the first min(nt, cap) tiles), [nf_buf,
  // nf_all) streamed
  const int T = (W + TILE_ROWS - 1) / TILE_ROWS;
  const int per = T / n, rem = T % n;
  const int t0 = rank * per + min(rank, rem);
  const int nt = per + (rank < rem ? 1 : 0);
  const int r0 = t0 * TILE_ROWS;
  const int nf_all = (min(W, r0 + nt * TILE_ROWS) - r0) * 32;
  const int nf_buf = min(nf_all, cap * TILE_F4);
  const float4* mine = x + ((size_t)u * W + r0) * 32;

  for (int f = tid; f < nf_buf; f += K1_THREADS) {
    cp_async16(staged + f, mine + f);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // phase 0: max |x| bits, the streamed tiles while the copies land
  unsigned m = 0u;
  auto fold_max = [&](float4 v, int) {
    m = max(m, __float_as_uint(v.x) & ABS_MASK);
    m = max(m, __float_as_uint(v.y) & ABS_MASK);
    m = max(m, __float_as_uint(v.z) & ABS_MASK);
    m = max(m, __float_as_uint(v.w) & ABS_MASK);
  };
  walk<8>(mine, nf_buf, nf_all, fold_max);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  walk<4>(staged, 0, nf_buf, fold_max);
  m = block_reduce<K1_THREADS>(m, 0u, MaxOp());
  if (tid == 0) sh.max_bits = m;
  cluster.sync();                     // 1: every rank's max is published

  if (warp == 0) {
    unsigned v = 0u;
    if (lane < n) v = *cluster.map_shared_rank(&sh.max_bits, lane);
    v = warp_reduce(v, MaxOp());
    const Cutoff cut = threshold_cutoff(safe_den(__uint_as_float(v)), lam);
    if (lane == 0) {
      sh.cut = cut;
      sh.inf_bits = v;
    }
  }
  __syncthreads();

  // phase 1: count and min over the high-resolution valid elements
  const Cutoff cut = sh.cut;
  const int e_base = r0 * 128;                      // element index at f = 0
  unsigned mn = F32_INF_BITS, cnt = 0u;
  auto fold_hi = [&](float4 v, int f) {
    const int e0 = e_base + 4 * f;
    const float a[4] = {fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w)};
    const bool whole = e0 + 4 <= d_valid;           // all but the last rows
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (in_cut(a[k], cut) && (whole || e0 + k < d_valid)) {
        mn = min(mn, __float_as_uint(a[k]));
        ++cnt;
      }
    }
  };
  walk<8>(mine, nf_buf, nf_all, fold_hi);
  walk<4>(staged, 0, nf_buf, fold_hi);
  mn = block_reduce<K1_THREADS>(mn, F32_INF_BITS, MinOp());
  cnt = block_reduce<K1_THREADS>(cnt, 0u, AddOp());
  if (tid == 0) {
    *cluster.map_shared_rank(&sh.min_bits[rank], 0) = mn;
    *cluster.map_shared_rank(&sh.count[rank], 0) = cnt;
  }
  cluster.sync();                     // 2: rank 0 holds every (min, count)

  if (rank == 0 && warp == 0) {
    const unsigned rmn = warp_reduce(lane < n ? sh.min_bits[lane]
                                              : F32_INF_BITS, MinOp());
    const unsigned rcnt = warp_reduce(lane < n ? sh.count[lane] : 0u,
                                      AddOp());
    if (lane < HEADER_LANES) {
      float val = 0.0f;
      if (lane == H_INF) {
        val = __uint_as_float(sh.inf_bits > F32_INF_BITS ? F32_NAN_CANON_BITS
                                                         : sh.inf_bits);
      }
      if (lane == H_DWQ) val = __uint_as_float(rmn);
      if (lane == H_DBAR) val = (float)rcnt;
      head[(size_t)u * HEADER_LANES + lane] = val;
    }
  }
}

// ---------------------------------------------------------------- K2
// Replaces mixed_res_emit (src/repro/kernels/mixed_res.py:198, body
// _emit_kernel :154).  Bound: device memory, x read once (U*W*512
// bytes) and the planes written once (U*W*(32 + 16*bw) bytes).  The
// design keeps bytes in flight and spends few instructions an element:
//
// * Grid (W / 64 rows, U), 8 warps a block; the users run last to first,
//   so the rows K1 read last, still in L2, come first.
//   A warp loads 2 rows at once with 16-byte loads (lane j holds
//   elements 4j..4j+3 of each row), 16 KB in flight a block; smaller
//   blocks with fewer rows in flight a warp measured faster at the main
//   shape than 128-row blocks with 4 (PERF.md).
// * The cutoff replaces the threshold division (the anchored rule is
//   lo = dw_q, hi = +inf); warp 0 finds it while the first rows load.
//   The code quotient stays an IEEE division (its bits are the code),
//   taken only where an element is high resolution.
// * Lane j's 4 sign and 4 hi bits are a nibble at bit 4(j % 8) of word
//   j / 8; xor-shuffles OR the 8 nibbles, lane 0 gathers a row's 4
//   sign words and lane 1 its 4 hi words, each one 16-byte store.
//   Codes: at bw = 16 a lane's 4 codes are 2 words, one 8-byte store
//   (the warp writes the row's 256 bytes at once); narrower codes
//   combine 2 (bw = 4) or 4 (bw = 2) lanes' codes by shuffles.

constexpr int K2_RPW = 2;                        // rows in flight a warp
constexpr int K2_ROWS = 64;                      // rows a block

template <int BW>
__global__ void __launch_bounds__(THREADS)
k2_emit(const float4* __restrict__ x, const float* __restrict__ head,
        uint4* __restrict__ signs, uint4* __restrict__ hi,
        unsigned* __restrict__ codes, int U, int W, int d_valid,
        float levels, int anchored) {
  constexpr int CPR = 4 * BW;                    // code words a row
  __shared__ Cutoff cut_sh;
  const int u = U - 1 - (int)blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r1 = min(W, ((int)blockIdx.x + 1) * K2_ROWS);
  const float4* xu = x + (size_t)u * W * 32;
  const float* h = head + (size_t)u * HEADER_LANES;
  const float dwq = h[H_DWQ];
  const float safe_step = safe_den(h[H_STEP]);

  int row0 = (int)blockIdx.x * K2_ROWS + warp * K2_RPW;
  float4 v[K2_RPW];
  auto load = [&]() {
#pragma unroll
    for (int k = 0; k < K2_RPW; ++k) {
      if (row0 + k < r1) v[k] = xu[(row0 + k) * 32 + lane];
    }
  };
  load();
  Cutoff cut{dwq, __uint_as_float(F32_INF_BITS)};
  if (!anchored) {
    if (warp == 0) {
      const Cutoff c = threshold_cutoff(safe_den(h[H_INF]), h[H_LAM]);
      if (lane == 0) cut_sh = c;
    }
    __syncthreads();
    cut = cut_sh;
  }

  const unsigned nib_shift = 4u * (lane & 7);
  while (row0 < r1) {
#pragma unroll
    for (int k = 0; k < K2_RPW; ++k) {
      const int row = row0 + k;
      if (row >= r1) break;                      // warp-uniform
      const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      const int lim = d_valid - row * 128 - 4 * lane;
      unsigned sn = 0u, hn = 0u, q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = fabsf(e[i]);
        const bool hb = in_cut(a, cut) && i < lim;
        sn |= (e[i] > 0.0f ? 1u : 0u) << i;
        hn |= (hb ? 1u : 0u) << i;
        // zeroed off the hi set, clamped to the grid top so an
        // underestimated anchor never spills into the neighbouring slot
        // (a NaN quotient codes 0, as the plain version's integer cast)
        float code = 0.0f;
        if (hb) code = rintf(__fdiv_rn(__fsub_rn(a, dwq), safe_step));
        q[i] = __float2uint_rz(code > levels ? levels : code);
      }
      unsigned sw = sn << nib_shift, hw = hn << nib_shift;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        sw |= __shfl_xor_sync(FULL, sw, o);
        hw |= __shfl_xor_sync(FULL, hw, o);
      }
      // lanes 8c hold word c; lane 0 gathers the sign words from the
      // even lanes 8, 16, 24, lane 1 the hi words from the odd 9, 17, 25
      const unsigned mine = (lane & 1) ? hw : sw;
      const unsigned w1 = __shfl_sync(FULL, mine, 8 + lane);
      const unsigned w2 = __shfl_sync(FULL, mine, 16 + lane);
      const unsigned w3 = __shfl_sync(FULL, mine, 24 + lane);
      const size_t r = (size_t)u * W + row;
      if (lane == 0) signs[r] = make_uint4(sw, w1, w2, w3);
      if (lane == 1) hi[r] = make_uint4(hw, w1, w2, w3);
      unsigned* cr = codes + r * CPR;
      if (BW == 16) {
        reinterpret_cast<uint2*>(cr)[lane] =
            make_uint2(q[0] | (q[1] << 16), q[2] | (q[3] << 16));
      } else if (BW == 8) {
        cr[lane] = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
      } else if (BW == 4) {
        const unsigned c = q[0] | (q[1] << 4) | (q[2] << 8) | (q[3] << 12);
        const unsigned odd = __shfl_xor_sync(FULL, c, 1);
        if (!(lane & 1)) cr[lane >> 1] = c | (odd << 16);
      } else {
        unsigned c = (q[0] | (q[1] << 2) | (q[2] << 4) | (q[3] << 6))
                     << (8 * (lane & 3));
        c |= __shfl_xor_sync(FULL, c, 1);
        c |= __shfl_xor_sync(FULL, c, 2);
        if (!(lane & 3)) cr[lane >> 2] = c;
      }
    }
    row0 += WARPS * K2_RPW;
    load();
  }
}

// the cutoff of each (inf, lam) pair, one warp a pair: the search K1 and
// K2 run, exposed so the card's answers can be held to the plain twin
__global__ void __launch_bounds__(THREADS)
k_cutoffs(const float* __restrict__ inf, const float* __restrict__ lam,
          float* __restrict__ out, int n) {
  const int i = (int)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;                            // warp-uniform
  const Cutoff c = threshold_cutoff(safe_den(inf[i]), lam[i]);
  if ((threadIdx.x & 31) == 0) {
    out[2 * i] = c.lo;
    out[2 * i + 1] = c.hi;
  }
}

// ---------------------------------------------------------------- K3
// One thread per output element; it folds the G users left to right,
// ((acc + u_0) + u_1) + ..., with w folded into the grid scalars exactly
// as the plain version does.  Threads of a warp share the (row, word)
// of the sign and hi planes, so those loads are broadcasts.

__global__ void __launch_bounds__(THREADS)
k3_dequant_reduce(const unsigned* __restrict__ signs,
                  const unsigned* __restrict__ hi,
                  const unsigned* __restrict__ codes,
                  const float* __restrict__ head,
                  const float* __restrict__ w,
                  const float* __restrict__ acc,
                  float* __restrict__ out, int G, long long W, int bw) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= W * 128) return;
  const long long r = i >> 7;
  const int e = (int)(i & 127), c = e >> 5, j = e & 31;
  const int per = 32 / bw, cpr = 4 * bw;
  const int cword = e / per, cshift = (e % per) * bw;
  const unsigned cmask = (1u << bw) - 1u;
  float total = 0.0f;
  for (int g = 0; g < G; ++g) {
    const long long base = (long long)g * W + r;
    const unsigned sw = signs[base * 4 + c];
    const unsigned hw = hi[base * 4 + c];
    const unsigned cw = codes[base * cpr + cword];
    const float code = (float)((cw >> cshift) & cmask);
    const float wg = w[g];
    const float wdq = __fmul_rn(wg, head[(size_t)g * HEADER_LANES + H_DWQ]);
    const float wst = __fmul_rn(wg, head[(size_t)g * HEADER_LANES + H_STEP]);
    const float mag = ((hw >> j) & 1u) ? __fadd_rn(wdq, __fmul_rn(code, wst))
                                       : __fmul_rn(wdq, 0.5f);
    const float val = ((sw >> j) & 1u) ? mag : -mag;
    if (g == 0) total = acc ? __fadd_rn(acc[i], val) : val;
    else total = __fadd_rn(total, val);
  }
  out[i] = total;
}

int code_width(int b) {
  for (int w = 2; w <= 16; w *= 2) if (w >= b) return w;
  return -1;
}

int k1_smem_bytes(int cap) { return K1_HEAD_BYTES + cap * TILE_F4 * 16; }

// once a device: dynamic shared memory up to the most a block may use,
// clusters of up to 16, and the carveout that lets blocks share an SM
cudaError_t k1_prepare() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ready[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(k1_reduce,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k1_smem_bytes(K1_CAP_MAX));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(k1_reduce,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(k1_reduce,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess && dev < 64) ready[dev] = true;
  return e;
}

void k1_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int U,
               int n, int cap, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(n, U);
  cfg->blockDim = dim3(K1_THREADS);
  cfg->dynamicSmemBytes = k1_smem_bytes(cap);
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

bool k1_shape_ok(int n, int cap) {
  return n >= 1 && n <= K1_CLUSTER_MAX && cap >= 1 && cap <= K1_CAP_MAX;
}

}  // namespace

extern "C" {

// K1.  x: [U, W, 128] f32 (16-byte aligned) -> head: [U, 8] f32, every
// lane written.  n: blocks in a user's cluster (1..16); cap: tiles of 16
// rows a block stages in shared memory (1..28).  The users lie on
// gridDim.y, so U <= 65535 a launch; the wrapper launches more users in
// chunks at pointer offsets (mixed_res.user_chunks).
int mr_reduce(const float* x, float* head, int U, int W, int d_valid,
              float lam, int n, int cap, void* stream) {
  if (U < 1 || U > 65535 || W < 1 || W > MAX_ROWS || d_valid < 1 ||
      !k1_shape_ok(n, cap)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = k1_prepare();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  k1_config(&cfg, attr, U, n, cap, static_cast<cudaStream_t>(stream));
  const float4* x4 = reinterpret_cast<const float4*>(x);
  void* args[] = {&x4, &head, &W, &d_valid, &lam, &cap};
  e = cudaLaunchKernelExC(&cfg, (const void*)k1_reduce, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K1's residency: clusters of n blocks staging cap tiles each that the
// card holds at once, and blocks an SM holds.
int mr_reduce_occupancy(int n, int cap, int* clusters, int* blocks_per_sm) {
  if (!k1_shape_ok(n, cap)) return (int)cudaErrorInvalidValue;
  cudaError_t e = k1_prepare();
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k1_reduce, K1_THREADS, k1_smem_bytes(cap));
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  k1_config(&cfg, attr, 1, n, cap, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)k1_reduce,
                                             &cfg);
}

// K2.  x: [U, W, 128] f32 (16-byte aligned); head: [U, 8] f32 -> signs,
// hi: [U, W, 4] u32, codes: [U, W, 4 * bw] u32.  U <= 65535 a launch,
// as for K1.
int mr_emit(const float* x, const float* head, unsigned* signs,
            unsigned* hi, unsigned* codes, int U, int W, int d_valid, int b,
            int anchored, void* stream) {
  const int bw = code_width(b);
  if (U < 1 || U > 65535 || W < 1 || W > MAX_ROWS || bw < 0 || b < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const float levels = (float)((1 << b) - 1);
  const dim3 grid((unsigned)((W + K2_ROWS - 1) / K2_ROWS), (unsigned)U);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  uint4* s4 = reinterpret_cast<uint4*>(signs);
  uint4* h4 = reinterpret_cast<uint4*>(hi);
  switch (bw) {
    case 2:
      k2_emit<2><<<grid, THREADS, 0, s>>>(x4, head, s4, h4, codes, U, W,
                                          d_valid, levels, anchored);
      break;
    case 4:
      k2_emit<4><<<grid, THREADS, 0, s>>>(x4, head, s4, h4, codes, U, W,
                                          d_valid, levels, anchored);
      break;
    case 8:
      k2_emit<8><<<grid, THREADS, 0, s>>>(x4, head, s4, h4, codes, U, W,
                                          d_valid, levels, anchored);
      break;
    default:
      k2_emit<16><<<grid, THREADS, 0, s>>>(x4, head, s4, h4, codes, U, W,
                                           d_valid, levels, anchored);
  }
  return (int)cudaGetLastError();
}

// The cutoff (lo, hi) of each (inf, lam) pair: inf, lam [n] f32 -> out
// [n, 2] f32.
int mr_cutoffs(const float* inf, const float* lam, float* out, int n,
               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + WARPS - 1) / WARPS);
  k_cutoffs<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      inf, lam, out, n);
  return (int)cudaGetLastError();
}

// K3.  signs, hi: [G, W, 4] u32; codes: [G, W, 4 * bw] u32; head: [G, 8]
// f32; w: [G] f32; acc: [W, 128] f32 or null -> out: [W, 128] f32.
int mr_dequant_reduce(const unsigned* signs, const unsigned* hi,
                      const unsigned* codes, const float* head,
                      const float* w, const float* acc, float* out, int G,
                      long long W, int b, void* stream) {
  const int bw = code_width(b);
  if (G < 1 || W < 1 || bw < 0 || b < 1) return (int)cudaErrorInvalidValue;
  const long long n = W * 128;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  k3_dequant_reduce<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      signs, hi, codes, head, w, acc, out, G, W, bw);
  return (int)cudaGetLastError();
}

const char* mr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

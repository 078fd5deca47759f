// Flash-decode attention K6 for Hopper (sm_90a), plain C interface for
// ctypes.  Replaces the Pallas kernel flash_decode (_flash_decode_kernel)
// of the JAX package (src/repro/kernels/flash_decode.py:69, body :27) and
// computes what its plain PyTorch version flash_decode_ref
// (src/repro_torch/kernels/ref.py) computes: one query token per (batch,
// kv head) carrying its GQA group of G query heads, attending over the
// cache positions < length with scores q.k / sqrt(D) in f32, p in f32,
// the output in q's type.
//
// What bounds it.  At full length, device memory: each cache position is
// read once (D + Dv values) for about 2G(D + Dv) operations, far below the
// card's operations-per-byte line, so the kernel must keep enough bytes in
// flight to run at the card's read rate and hide its arithmetic under the
// reads.  At the serve loop's short lengths almost nothing is read, and
// the bound is latency: the launch, one tile's round trip and the merge.
// The design answers each:
//
// * Split sized on the device.  The grid (nsplit, Hkv, B) depends only on
//   shapes (nsplit: the most blocks per (b, h), up to 8, whose clusters
//   are all resident at once; the wrapper asks the card once a shape), so
//   a CUDA graph replays one launch at any length.  Each block reads
//   *length and computes n_eff = clamp(ceil(len / MIN_CHUNK), 1, nsplit)
//   and its range: len's 64-position tiles shared evenly over the first
//   n_eff splits (split_ranges in flash_decode.py is the same arithmetic).
//   Blocks past n_eff load nothing and leave at once.
// * Merge in a thread-block cluster.  The nsplit blocks of one (b, h) are
//   one cluster (launched with cudaLaunchKernelEx).  Each block leaves its
//   (m, l, acc) in its own shared memory; after cluster.sync() each active
//   rank reads the states of ranks < n_eff through distributed shared
//   memory, in split order, and writes its share of the output; a second
//   cluster.sync() keeps every block's shared memory alive until all reads
//   are done.  When n_eff = 1 (len <= MIN_CHUNK) rank 0 writes its own
//   state and no block syncs.  No scratch in device memory, no counters,
//   no fence, no memset: one launch a call, and the fixed order makes
//   every run bit-identical.
// * Staged, coalesced reads.  The k and v rows of a 64-position tile are
//   copied into a ring of tiles in shared memory (four for bf16: three in
//   flight while one is computed; two for f32) with 16-byte cp.async.cg,
//   consecutive threads on consecutive 16 bytes of a row (a bf16 row of
//   D=128 is 16 threads); each thread's walk over the pieces is set up
//   once.  Rows are padded to an odd number of 16-byte units, so the
//   8-row reads of q.k hit each bank once.  One block of 8 warps fills an
//   SM (136 KB at the serve shape, whose 128 blocks all run at once).
// * Arithmetic.  Each warp takes 8 positions of a tile.  bf16: q.k on the
//   tensor cores, mma.sync m16n8k16 with q as A (rows = the G query heads,
//   in registers; KS k-steps cover D) and the 8 k rows as B; products of
//   two bf16 values are exact in f32, so only the order of the f32 sums
//   changes.  f32: q.k on the CUDA cores, four lanes a position.  Then the
//   online softmax with the JAX kernel's guards (m_safe = isfinite(m_new)
//   ? m_new : 0; scale = isfinite(m_prev) ? exp(m_prev - m_safe) : 0), one
//   lane per (position, head); p stays f32 and p.v runs on the CUDA
//   cores, each lane owning Dv/32 output columns of every head.  The
//   warps' states merge in warp order in shared memory, the splits in
//   split order, and the output is acc / max(l, 1e-30).
//
// Numerics: f32 throughout, IEEE expf and division (no fast-math in the
// build); the sums run in another order than the plain version's, so the
// two agree to roundoff, not bit for bit.
//
// Supported: f32 or bf16 (q, k, v of one type), G <= 8, D a multiple of 8
// up to 256, Dv in {64, 128}, any S; the wrapper checks the rest (16-byte
// aligned rows, strides in multiples of 8 elements).
//
// The entry point launches on the given stream with cudaLaunchKernelExC,
// does not synchronise, and returns the launch's error: a refused launch
// (a cluster that cannot be placed, too much shared memory) is an error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WPOS = 8;                   // positions per warp in a tile
constexpr int TILE = WARPS * WPOS;        // positions per tile (a stage)
constexpr int MIN_CHUNK = 128;            // least positions of an active split
constexpr int CLUSTER_MAX = 8;            // portable cluster size
constexpr int D_MAX = 256;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Tiles in the ring: four bf16 tiles (three in flight while one is
// computed); f32 rows are twice as long, so two (one in flight) keep the
// largest f32 shape (D=256, Dv=128) within a block's shared memory.
__host__ __device__ constexpr int stages_of(int es) { return es == 2 ? 4 : 2; }

// Dynamic shared memory, the same on host and device: the ring of tiles,
// reused after the loop for the warps' and the block's (m, l, acc); then,
// for f32, q as f32.
struct Layout {
  int row_k, row_v, stage, ws, main, total;
};

__host__ __device__ inline Layout layout(int es, int GM, int D, int Dv) {
  Layout s;
  s.row_k = round_up(D * es, 32) + 16;    // odd number of 16-byte units
  s.row_v = round_up(Dv * es, 32) + 16;
  s.stage = TILE * (s.row_k + s.row_v);
  s.ws = WARPS * GM * (Dv + 2) * 4;
  const int blk = GM * (Dv + 2) * 4;
  const int ring = stages_of(es) * s.stage;
  s.main = round_up(ring > s.ws + blk ? ring : s.ws + blk, 16);
  s.total = s.main + (es == 4 ? GM * D * 4 : 0);
  return s;
}

__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// N consecutive values of type T in shared memory at p as f32
template <typename T, int N>
__device__ __forceinline__ void smem_vals(const unsigned char* p,
                                          float* out) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(p);
      out[0] = t.x; out[1] = t.y;
    }
  } else {
    if constexpr (N == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      out[0] = lo_bf16(t.x); out[1] = hi_bf16(t.x);
      out[2] = lo_bf16(t.y); out[3] = hi_bf16(t.y);
    } else {
      const unsigned t = *reinterpret_cast<const unsigned*>(p);
      out[0] = lo_bf16(t); out[1] = hi_bf16(t);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += A(16x16 bf16, rows 8-15 zero) . B(16x8 bf16), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a2,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float rescale(float m, float m_safe) {
  return isfinite(m) ? expf(m - m_safe) : 0.0f;
}

// A thread's walk over the 16-byte pieces of a tile's rows: consecutive
// threads on consecutive pieces of a row; set up once, so a tile's copy
// costs no division.
struct RowWalk {
  int chunks, r0, c0, rstep, cstep;
  __device__ RowWalk(int row_bytes)
      : chunks(row_bytes / 16),
        r0(threadIdx.x / chunks), c0(threadIdx.x % chunks),
        rstep(THREADS / chunks), cstep(THREADS % chunks) {}
  // rows [0, rows) of src (row stride src_stride bytes) to dst (row
  // stride dst_stride)
  __device__ __forceinline__ void copy(unsigned char* dst, int dst_stride,
                                       const unsigned char* src,
                                       long long src_stride,
                                       int rows) const {
    int r = r0, c = c0;
    while (r < rows) {
      cp_async16(dst + r * dst_stride + c * 16,
                 src + r * src_stride + c * 16);
      r += rstep;
      c += cstep;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  }
};

// out[g, d] = sum_r f_r acc_r / max(sum_r f_r l_r, 1e-30) over the first
// n block states (m [GM], l [GM], acc [GM, DV] each), in order, with f_r =
// exp(m_r - max_r m_r) (0 for a state with no position); for the flat
// output indices e = g DV + d in [e0, e1)
template <typename T, int GM, int DV, int N>
__device__ __forceinline__ void write_out(T* __restrict__ ob,
                                          const float* const* st, int n,
                                          int e0, int e1) {
  for (int e = e0 + threadIdx.x; e < e1; e += THREADS) {
    const int g = e / DV;
    float mr[N];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      mr[r] = r < n ? st[r][g] : -INFINITY;
      mx = fmaxf(mx, mr[r]);
    }
    const float ms = isfinite(mx) ? mx : 0.0f;
    float a = 0.0f, l = 0.0f;
#pragma unroll
    for (int r = 0; r < N; ++r) {
      if (r < n) {
        const float f = rescale(mr[r], ms);
        a = fmaf(f, st[r][2 * GM + e], a);
        l = fmaf(f, st[r][GM + g], l);
      }
    }
    ob[e] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

// GM: G rounded up to 1, 2, 4 or 8; VV = Dv / 32; KS: mma k-steps that
// cover D (bf16: 8 for D <= 128, else 16; f32: unused)
template <typename T, int GM, int VV, int KS>
__global__ void __launch_bounds__(THREADS, 1)
k6_flash_decode(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ length_p,
                T* __restrict__ out, int Hkv, int G, int D, int S,
                int nsplit, long long ksb, long long kss, long long ksh,
                long long vsb, long long vss, long long vsh) {
  constexpr bool BF = !std::is_same<T, float>::value;
  constexpr int ES = sizeof(T);
  constexpr int DV = 32 * VV;
  constexpr int NSLOT = (GM + 3) / 4;     // heads per lane in the softmax
  constexpr int STAGES = stages_of(ES);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) float sc_s[WARPS][GM][WPOS];
  __shared__ __align__(16) float p_s[WARPS][WPOS][GM];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * Hkv + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Layout lay = layout(ES, GM, D, DV);

  // q, loaded before length is known: bf16 as mma A fragments in
  // registers, f32 in shared memory
  const T* qg = q + bh * G * D;
  const int gid = lane >> 2, tig = lane & 3;
  unsigned qa[KS][2];
  float* q_s = reinterpret_cast<float*>(smem + lay.main);
  if constexpr (BF) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int d = ks * 16 + 2 * tig;
      const unsigned* row = reinterpret_cast<const unsigned*>(qg + gid * D);
      qa[ks][0] = (gid < G && ks * 16 < D) ? row[d / 2] : 0u;
      qa[ks][1] = (gid < G && ks * 16 + 8 < D) ? row[d / 2 + 4] : 0u;
    }
  } else {
    for (int i = threadIdx.x; i < G * D; i += THREADS) q_s[i] = qg[i];
  }

  // this split's range: len's tiles shared evenly over the first n_eff
  const int len = min(S, max(*length_p, 0));
  const int tiles = (len + TILE - 1) / TILE;
  const int n_eff = min(max((len + MIN_CHUNK - 1) / MIN_CHUNK, 1), nsplit);
  int start = 0, end = 0;
  if (split < n_eff) {
    const int per = tiles / n_eff, rem = tiles % n_eff;
    const int t0 = split * per + min(split, rem);
    start = t0 * TILE;
    end = min((t0 + per + (split < rem ? 1 : 0)) * TILE, len);
  }

  // after the loop: warps' (m, l, acc), then the block's (m, l, acc)
  float* ws_m = reinterpret_cast<float*>(smem);
  float* ws_l = ws_m + WARPS * GM;
  float* ws_acc = ws_l + WARPS * GM;                  // [WARPS][GM][DV]
  float* blk = reinterpret_cast<float*>(smem + lay.ws);
  float* blk_m = blk;
  float* blk_l = blk + GM;
  float* blk_acc = blk + 2 * GM;                      // [GM][DV]

  if (start < end) {
    const float sqrt_d = sqrtf((float)D);

    const int ntiles = (end - start + TILE - 1) / TILE;
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(
        k + b * ksb + h * ksh + (long long)start * kss);
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(
        v + b * vsb + h * vsh + (long long)start * vss);
    const RowWalk walk_k(D * ES), walk_v(DV * ES);
    auto prefetch = [&](int t) {  // tile t of the range into its stage
      if (t < ntiles) {
        unsigned char* st = smem + (t % STAGES) * lay.stage;
        const int rows = min(TILE, end - start - t * TILE);
        walk_k.copy(st, lay.row_k, kb + (long long)t * TILE * kss * ES,
                    kss * ES, rows);
        walk_v.copy(st + TILE * lay.row_k, lay.row_v,
                    vb + (long long)t * TILE * vss * ES, vss * ES, rows);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) prefetch(t);

    const int j = lane & 7, gq = lane >> 3;     // softmax: (position, head)
    float m_r[NSLOT], l_r[NSLOT], acc[GM][VV];
#pragma unroll
    for (int s = 0; s < NSLOT; ++s) {
      m_r[s] = -INFINITY;
      l_r[s] = 0.0f;
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int i = 0; i < VV; ++i) acc[g][i] = 0.0f;
    }

    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();            // tile t landed; tile t-1's stage is free
      prefetch(t + STAGES - 1);
      const unsigned char* st = smem + (t % STAGES) * lay.stage;
      const int nw = min(WPOS, end - start - t * TILE - warp * WPOS);
      if (nw <= 0) continue;      // warp-uniform: the ragged last tile
      const unsigned char* kt = st + warp * WPOS * lay.row_k;

      // raw scores q.k of this warp's 8 positions -> sc_s[warp][g][pos]
      if constexpr (BF) {
        // two accumulators (even and odd k-steps) halve the mma chain;
        // past D, q and b are 0, so no branch makes the warp reconverge
        float c[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const unsigned char* kr = kt + gid * lay.row_k + 4 * tig + ks * 32;
          const unsigned b0 =
              ks * 16 < D ? *reinterpret_cast<const unsigned*>(kr) : 0u;
          const unsigned b1 =
              ks * 16 + 8 < D ? *reinterpret_cast<const unsigned*>(kr + 16)
                              : 0u;
          mma_bf16(c[ks & 1], qa[ks][0], qa[ks][1], b0, b1);
        }
        if (gid < G) {
          sc_s[warp][gid][2 * tig] = c[0][0] + c[1][0];
          sc_s[warp][gid][2 * tig + 1] = c[0][1] + c[1][1];
        }
      } else {
        // lane (c4, p): position p, 16-byte chunks c4, c4 + 4, ... of D
        const int c4 = lane >> 3, p = lane & 7;
        const float* kr = reinterpret_cast<const float*>(kt + p * lay.row_k);
        float s[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] = 0.0f;
        for (int ch = c4; ch < D / 4; ch += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * ch);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < G) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(q_s + g * D + 4 * ch);
              s[g] = fmaf(qv.x, kv.x, s[g]);
              s[g] = fmaf(qv.y, kv.y, s[g]);
              s[g] = fmaf(qv.z, kv.z, s[g]);
              s[g] = fmaf(qv.w, kv.w, s[g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          s[g] += __shfl_xor_sync(FULL, s[g], 8);
          s[g] += __shfl_xor_sync(FULL, s[g], 16);
          if (g < G && c4 == 0) sc_s[warp][g][p] = s[g];
        }
      }
      __syncwarp();

      // online softmax: lane (j, gq) takes position j of heads gq + 4 s
      float scale_r[NSLOT];
#pragma unroll
      for (int s = 0; s < NSLOT; ++s) {
        const int g = gq + 4 * s;
        const float sc = (g < G && j < nw) ? sc_s[warp][g][j] / sqrt_d
                                           : -INFINITY;
        float mx = sc;
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
        const float m_new = fmaxf(m_r[s], mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.0f;
        const float pj = isfinite(sc) ? expf(sc - m_safe) : 0.0f;
        if (g < GM) p_s[warp][j][g] = pj;     // 0 for the heads past G
        float ps = pj;
        ps += __shfl_xor_sync(FULL, ps, 1);
        ps += __shfl_xor_sync(FULL, ps, 2);
        ps += __shfl_xor_sync(FULL, ps, 4);
        scale_r[s] = rescale(m_r[s], m_safe);
        l_r[s] = l_r[s] * scale_r[s] + ps;
        m_r[s] = m_new;
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float sg = __shfl_sync(FULL, scale_r[g / 4], (g % 4) * 8);
#pragma unroll
        for (int i = 0; i < VV; ++i) acc[g][i] *= sg;
      }
      __syncwarp();

      // p.v: lane owns columns lane*VV .. lane*VV + VV - 1 of every head
      const unsigned char* vt =
          st + TILE * lay.row_k + warp * WPOS * lay.row_v + lane * VV * ES;
      for (int jj = 0; jj < nw; ++jj) {
        float vv[VV];
        smem_vals<T, VV>(vt + jj * lay.row_v, vv);
        float pg[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) pg[g] = p_s[warp][jj][g];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
#pragma unroll
          for (int i = 0; i < VV; ++i) acc[g][i] = fmaf(pg[g], vv[i], acc[g][i]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();              // the ring is free: reuse it for the merge

#pragma unroll
    for (int s = 0; s < NSLOT; ++s) {
      const int g = gq + 4 * s;
      if (g < G && j == 0) {
        ws_m[warp * GM + g] = m_r[s];
        ws_l[warp * GM + g] = l_r[s];
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
#pragma unroll
        for (int i = 0; i < VV; ++i) {
          ws_acc[(warp * GM + g) * DV + lane * VV + i] = acc[g][i];
        }
      }
    }
    __syncthreads();
    // the block's state: the warps' merged in warp order
    for (int e = threadIdx.x; e < G * DV; e += THREADS) {
      const int g = e / DV, col = e % DV;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ws_m[w * GM + g]);
      const float ms = isfinite(mx) ? mx : 0.0f;
      float a = 0.0f, l = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = rescale(ws_m[w * GM + g], ms);
        a = fmaf(f, ws_acc[(w * GM + g) * DV + col], a);
        l = fmaf(f, ws_l[w * GM + g], l);
      }
      blk_acc[g * DV + col] = a;
      if (col == 0) {
        blk_m[g] = mx;
        blk_l[g] = l;
      }
    }
  } else if (split == 0) {        // len == 0: rank 0 holds the empty state
    for (int e = threadIdx.x; e < G * DV; e += THREADS) {
      const int g = e / DV;
      blk_acc[e] = 0.0f;
      if (e % DV == 0) {
        blk_m[g] = -INFINITY;
        blk_l[g] = 0.0f;
      }
    }
  }

  if (n_eff == 1) {               // one split holds every position:
    if (split == 0) {             // rank 0 needs no peer, nobody syncs
      __syncthreads();
      const float* self[1] = {blk};
      write_out<T, GM, DV, 1>(out + bh * G * DV, self, 1, 0, G * DV);
    }
    return;
  }
  // every block of the cluster arrives here, empty ones included; then
  // each active rank merges its share of the outputs from all n_eff
  // states, read in split order through distributed shared memory
  cluster.sync();
  if (split < n_eff) {
    const float* peer[CLUSTER_MAX];
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) {
      peer[r] = r < n_eff ? cluster.map_shared_rank(blk, r) : blk;
    }
    const int share = (G * DV + n_eff - 1) / n_eff;
    write_out<T, GM, DV, CLUSTER_MAX>(out + bh * G * DV, peer, n_eff,
                                      split * share,
                                      min((split + 1) * share, G * DV));
  }
  // no block leaves while a peer may still read its shared memory
  cluster.sync();
}

// The kernel instance for a shape, its index among the instances, and
// the dynamic shared memory of a block.
struct Instance {
  const void* fn;
  int index, smem;
};

template <typename T, int VV, int KS>
Instance by_group(int G, int D, int base) {
  const int es = sizeof(T);
  if (G <= 1) return {(const void*)k6_flash_decode<T, 1, VV, KS>, base,
                      layout(es, 1, D, 32 * VV).total};
  if (G <= 2) return {(const void*)k6_flash_decode<T, 2, VV, KS>, base + 1,
                      layout(es, 2, D, 32 * VV).total};
  if (G <= 4) return {(const void*)k6_flash_decode<T, 4, VV, KS>, base + 2,
                      layout(es, 4, D, 32 * VV).total};
  return {(const void*)k6_flash_decode<T, 8, VV, KS>, base + 3,
          layout(es, 8, D, 32 * VV).total};
}

constexpr int N_INSTANCES = 24;

Instance pick(int dtype, int G, int D, int Dv) {
  if (dtype == 0) {
    return Dv == 64 ? by_group<float, 2, 1>(G, D, 0)
                    : by_group<float, 4, 1>(G, D, 4);
  }
  if (D <= 128) {
    return Dv == 64 ? by_group<__nv_bfloat16, 2, 8>(G, D, 8)
                    : by_group<__nv_bfloat16, 4, 8>(G, D, 12);
  }
  return Dv == 64 ? by_group<__nv_bfloat16, 2, 16>(G, D, 16)
                  : by_group<__nv_bfloat16, 4, 16>(G, D, 20);
}

// allow the instance its dynamic shared memory (once per device and size)
cudaError_t prepare(const Instance& k) {
  static int allowed[64][N_INSTANCES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && allowed[dev][k.index] >= k.smem) return cudaSuccess;
  e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k.smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(k.fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e == cudaSuccess && dev < 64) allowed[dev][k.index] = k.smem;
  return e;
}

// grid (nsplit, Hkv, B), one cluster of nsplit blocks per (b, h)
void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int B, int Hkv, int nsplit, int smem,
                   cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(nsplit, Hkv, B);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

bool shape_ok(int dtype, int B, int Hkv, int G, int D, int Dv, int nsplit) {
  return B >= 1 && B <= 65535 && Hkv >= 1 && Hkv <= 65535 && G >= 1 &&
         G <= 8 && D >= 8 && D <= D_MAX && D % 8 == 0 &&
         (Dv == 64 || Dv == 128) && nsplit >= 1 && nsplit <= CLUSTER_MAX &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// K6.  dtype 0 = f32, 1 = bf16.  q: [B, Hkv, G, D] contiguous; k: [B,
// Hkv, S, D] and v: [B, Hkv, S, Dv] at element strides (ksb, ksh, kss)
// and (vsb, vsh, vss), last dim contiguous; length: one int32 on the
// device; out: [B, Hkv, G, Dv] contiguous.  nsplit (1..8): blocks, one
// cluster, per (b, h), chosen from shapes alone.
int fd_flash_decode(int dtype, const void* q, const void* k, const void* v,
                    const int* length, void* out, int B, int Hkv, int G,
                    int D, int Dv, int S, int nsplit, long long ksb,
                    long long kss, long long ksh, long long vsb,
                    long long vss, long long vsh, void* stream) {
  if (!shape_ok(dtype, B, Hkv, G, D, Dv, nsplit) || S < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Instance kern = pick(dtype, G, D, Dv);
  cudaError_t e = prepare(kern);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, B, Hkv, nsplit, kern.smem,
                static_cast<cudaStream_t>(stream));
  void* args[] = {&q, &k, &v, &length, &out, &Hkv, &G, &D, &S, &nsplit,
                  &ksb, &kss, &ksh, &vsb, &vss, &vsh};
  e = cudaLaunchKernelExC(&cfg, kern.fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K6's residency at a shape: blocks an SM holds, clusters of nsplit the
// card holds at once, and the dynamic shared memory of a block.
int fd_occupancy(int dtype, int B, int Hkv, int G, int D, int Dv,
                 int nsplit, int* blocks_per_sm, int* clusters, int* smem) {
  if (!shape_ok(dtype, B, Hkv, G, D, Dv, nsplit)) {
    return (int)cudaErrorInvalidValue;
  }
  const Instance kern = pick(dtype, G, D, Dv);
  cudaError_t e = prepare(kern);
  if (e != cudaSuccess) return (int)e;
  *smem = kern.smem;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern.fn,
                                                    THREADS, kern.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(&cfg, attr, B, Hkv, nsplit, kern.smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern.fn, &cfg);
}

const char* fd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Flash-decode attention K6 for Hopper (sm_90a), plain C interface for
// ctypes.  Replaces the Pallas kernel flash_decode (_flash_decode_kernel)
// of the JAX package (src/repro/kernels/flash_decode.py) and computes
// what its plain PyTorch version flash_decode_ref
// (src/repro_torch/kernels/ref.py) computes: one query token per
// (batch, kv head) carrying its GQA group of G query heads, attending
// over the cache positions < length with scores q.k / sqrt(D), in f32,
// the output in q's type.
//
// What bounds it: device memory.  Each cache position is read once (D
// + Dv values) and costs about 2G(D + Dv) operations, far below the
// card's operations-per-byte line.  So the design reads k and v once,
// in their [B, S, Hkv, D] cache layout through strides (no transposed
// copy), and never reads a position >= length: a KV tile wholly past
// length leaves (m, l, acc) unchanged in the JAX kernel's formulation
// (its max is -inf and its scale 1), so it is skipped.  length is read
// from device memory, so the serve loop never syncs the host per layer.
//
// Grid: (nsplit, Hkv, B).  B*Hkv alone is 64 blocks at the serve shape,
// half the 132 SMs, so S is split into nsplit chunks, one block each.
// A block of 4 warps walks its chunk in tiles of 32 positions per warp:
//   * scores: lane i takes position t0 + i and dots its k row (16-byte
//     loads) with the G query rows kept in shared memory as f32;
//   * online softmax per query row over the tile, with the JAX kernel's
//     guards: m_safe = isfinite(m_new) ? m_new : 0, masked scores give
//     exp(-inf) = 0, scale = isfinite(m_prev) ? exp(m_prev - m_safe) : 0;
//   * p . v: lane i owns Dv/32 consecutive output columns; the warp
//     walks the tile's positions, each a coalesced v row load, with the
//     p values broadcast from shared memory.
// The block's warps merge their (m, l, acc) in shared memory, in warp
// order, and write one partial per block.  The last block of a (b, h) to
// finish (an atomic counter, zeroed by the wrapper) merges the nsplit
// partials in split order and writes acc / max(l, 1e-30).  The order is
// fixed, so a result does not change from run to run.
//
// Numerics: f32 throughout, IEEE expf and division (no fast-math in the
// build); the sums run in another order than the plain version's, so
// the two agree to roundoff, not bit for bit.
//
// Supported: f32 or bf16 (q, k, v of one type), G <= 8, D a multiple of
// 8 up to 256, Dv in {64, 128}, any S; the wrapper checks the rest
// (16-byte aligned rows, strides in multiples of 8 elements).
//
// The entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;     // positions per warp step, one per lane
constexpr int D_MAX = 256;

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ float lo_bf16(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __bfloat162float(x);
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// N consecutive values of type T at p (aligned to their byte size) as f32
template <typename T, int N>
__device__ __forceinline__ void load_vals(const T* __restrict__ p,
                                          float* out) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
        out[i] = t.x; out[i + 1] = t.y; out[i + 2] = t.z; out[i + 3] = t.w;
      }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p + i));
        out[i] = t.x; out[i + 1] = t.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = __ldg(p + i);
    }
  } else {
    if constexpr (N % 8 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 8) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p + i));
        out[i] = lo_bf16(t.x); out[i + 1] = hi_bf16(t.x);
        out[i + 2] = lo_bf16(t.y); out[i + 3] = hi_bf16(t.y);
        out[i + 4] = lo_bf16(t.z); out[i + 5] = hi_bf16(t.z);
        out[i + 6] = lo_bf16(t.w); out[i + 7] = hi_bf16(t.w);
      }
    } else if constexpr (N % 4 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(p + i));
        out[i] = lo_bf16(t.x); out[i + 1] = hi_bf16(t.x);
        out[i + 2] = lo_bf16(t.y); out[i + 3] = hi_bf16(t.y);
      }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const unsigned t = __ldg(reinterpret_cast<const unsigned*>(p + i));
        out[i] = lo_bf16(t); out[i + 1] = hi_bf16(t);
      }
    } else {
      const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
      for (int i = 0; i < N; ++i) out[i] = bf16_bits(__ldg(u + i));
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// exp(m - m_safe), 0 for a row with no position yet (m = -inf)
__device__ __forceinline__ float rescale(float m, float m_safe) {
  return isfinite(m) ? expf(m - m_safe) : 0.0f;
}

template <typename T, int GM, int VV>
__global__ void __launch_bounds__(THREADS)
k6_flash_decode(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ length_p,
                T* __restrict__ out, float* __restrict__ part_ml,
                float* __restrict__ part_acc,
                unsigned* __restrict__ counters, int Hkv, int G, int D,
                int S, int chunk, int nsplit, long long ksb, long long kss,
                long long ksh, long long vsb, long long vss, long long vsh) {
  constexpr int DV = 32 * VV;
  constexpr int CH = 16 / sizeof(T);          // elements per 16-byte load
  __shared__ float q_s[GM * D_MAX];
  __shared__ float p_s[WARPS][TILE][GM];
  __shared__ float m_s[GM], l_s[GM];
  __shared__ float acc_s[GM * DV];
  __shared__ bool last_s;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * Hkv + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int valid_len = min(S, max(*length_p, 0));
  const int start = split * chunk;
  const int end = min(start + chunk, valid_len);
  const float sqrt_d = sqrtf((float)D);

  const T* qg = q + bh * G * D;
  for (int i = threadIdx.x; i < G * D; i += THREADS) q_s[i] = to_f32(qg[i]);
  __syncthreads();

  float m[GM], l[GM], acc[GM][VV];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < VV; ++i) acc[g][i] = 0.0f;
  }

  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh + lane * VV;
  for (int t0 = start + warp * TILE; t0 < end; t0 += WARPS * TILE) {
    const int pos = t0 + lane;
    const bool valid = pos < end;
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.0f;
    if (valid) {
      const T* kr = kb + pos * kss;
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += CH) {
        float kv[CH];
        load_vals<T, CH>(kr + d0, kv);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float* qr = q_s + g * D + d0;
#pragma unroll
            for (int c = 0; c < CH; ++c) s[g] = fmaf(qr[c], kv[c], s[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float sc = valid ? s[g] / sqrt_d : -INFINITY;
        const float m_new = fmaxf(m[g], warp_max(sc));
        const float m_safe = isfinite(m_new) ? m_new : 0.0f;
        const float p = isfinite(sc) ? expf(sc - m_safe) : 0.0f;
        const float scale = rescale(m[g], m_safe);
        l[g] = l[g] * scale + warp_sum(p);
#pragma unroll
        for (int i = 0; i < VV; ++i) acc[g][i] *= scale;
        m[g] = m_new;
        p_s[warp][lane][g] = p;
      }
    }
    __syncwarp();
    const int n = min(TILE, end - t0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float vv[VV];
      load_vals<T, VV>(vb + (long long)(t0 + j) * vss, vv);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float p = p_s[warp][j][g];
#pragma unroll
          for (int i = 0; i < VV; ++i) acc[g][i] = fmaf(p, vv[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
  }

  // merge the warps' states in warp order
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float* ar = acc_s + g * DV + lane * VV;
          if (w == 0) {
#pragma unroll
            for (int i = 0; i < VV; ++i) ar[i] = acc[g][i];
            if (lane == 0) { m_s[g] = m[g]; l_s[g] = l[g]; }
          } else {
            const float mo = m_s[g], lo = l_s[g];
            const float mn = fmaxf(mo, m[g]);
            const float ms = isfinite(mn) ? mn : 0.0f;
            const float fo = rescale(mo, ms), fn = rescale(m[g], ms);
#pragma unroll
            for (int i = 0; i < VV; ++i) ar[i] = ar[i] * fo + acc[g][i] * fn;
            __syncwarp();
            if (lane == 0) { m_s[g] = mn; l_s[g] = lo * fo + l[g] * fn; }
          }
        }
      }
    }
    __syncthreads();
  }

  // this block's partial: m and l [G], acc [G, Dv] (acc only if the
  // block saw a position; the combine skips partials with m = -inf)
  const long long part = bh * nsplit + split;
  float* pml = part_ml + part * 2 * G;
  for (int g = threadIdx.x; g < G; g += THREADS) {
    pml[g] = m_s[g];
    pml[G + g] = l_s[g];
  }
  if (start < end) {
    float* pacc = part_acc + part * G * DV;
    for (int i = threadIdx.x; i < G * DV; i += THREADS) pacc[i] = acc_s[i];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last_s = atomicAdd(counters + bh, 1u) == (unsigned)(nsplit - 1);
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  // the last block of (b, h): merge the nsplit partials in split order
  const float* ml0 = part_ml + bh * nsplit * 2 * G;
  const float* acc0 = part_acc + bh * nsplit * G * DV;
  T* ob = out + bh * G * DV;
  for (int i = threadIdx.x; i < G * DV; i += THREADS) {
    const int g = i / DV;
    float mx = -INFINITY;
    for (int s2 = 0; s2 < nsplit; ++s2) {
      mx = fmaxf(mx, __ldcg(ml0 + s2 * 2 * G + g));
    }
    const float ms = isfinite(mx) ? mx : 0.0f;
    float lsum = 0.0f, a = 0.0f;
    for (int s2 = 0; s2 < nsplit; ++s2) {
      const float mp = __ldcg(ml0 + s2 * 2 * G + g);
      if (isfinite(mp)) {
        const float f = expf(mp - ms);
        lsum = fmaf(f, __ldcg(ml0 + s2 * 2 * G + G + g), lsum);
        a = fmaf(f, __ldcg(acc0 + (long long)s2 * G * DV + i), a);
      }
    }
    ob[i] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int GM, int VV>
int launch_k6(const void* q, const void* k, const void* v, const int* len,
              void* out, float* part_ml, float* part_acc,
              unsigned* counters, int B, int Hkv, int G, int D, int S,
              int chunk, int nsplit, long long ksb, long long kss,
              long long ksh, long long vsb, long long vss, long long vsh,
              cudaStream_t stream) {
  const dim3 grid(nsplit, Hkv, B);
  k6_flash_decode<T, GM, VV><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len, static_cast<T*>(out), part_ml,
      part_acc, counters, Hkv, G, D, S, chunk, nsplit, ksb, kss, ksh, vsb,
      vss, vsh);
  return (int)cudaGetLastError();
}

template <typename T, int VV>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const int* len, void* out, float* part_ml, float* part_acc,
               unsigned* counters, int B, int Hkv, int D, int S, int chunk,
               int nsplit, long long ksb, long long kss, long long ksh,
               long long vsb, long long vss, long long vsh,
               cudaStream_t stream) {
#define K6_ARGS q, k, v, len, out, part_ml, part_acc, counters, B, Hkv, G, \
    D, S, chunk, nsplit, ksb, kss, ksh, vsb, vss, vsh, stream
  if (G <= 1) return launch_k6<T, 1, VV>(K6_ARGS);
  if (G <= 2) return launch_k6<T, 2, VV>(K6_ARGS);
  if (G <= 4) return launch_k6<T, 4, VV>(K6_ARGS);
  return launch_k6<T, 8, VV>(K6_ARGS);
#undef K6_ARGS
}

}  // namespace

extern "C" {

// K6.  dtype 0 = f32, 1 = bf16.  q: [B, Hkv, G, D] contiguous; k: [B,
// Hkv, S, D] and v: [B, Hkv, S, Dv] at element strides (ksb, ksh, kss)
// and (vsb, vsh, vss), last dim contiguous; length: one int32 on the
// device; out: [B, Hkv, G, Dv] contiguous.  Scratch: part_ml [B*Hkv,
// nsplit, 2, G] f32, part_acc [B*Hkv, nsplit, G, Dv] f32, counters
// [B*Hkv] zeroed; chunk positions per block, nsplit = ceil(S / chunk).
int fd_flash_decode(int dtype, const void* q, const void* k, const void* v,
                    const int* length, void* out, float* part_ml,
                    float* part_acc, unsigned* counters, int B, int Hkv,
                    int G, int D, int Dv, int S, int chunk, int nsplit,
                    long long ksb, long long kss, long long ksh,
                    long long vsb, long long vss, long long vsh,
                    void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > 8 || D < 8 || D > D_MAX ||
      D % 8 != 0 || S < 1 || chunk < 1 || nsplit < 1 ||
      (long long)chunk * nsplit < S || (Dv != 64 && Dv != 128) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K6_ARGS q, k, v, length, out, part_ml, part_acc, counters, B, Hkv, \
    D, S, chunk, nsplit, ksb, kss, ksh, vsb, vss, vsh, st
  if (dtype == 0) {
    return Dv == 64 ? dispatch_g<float, 2>(G, K6_ARGS)
                    : dispatch_g<float, 4>(G, K6_ARGS);
  }
  return Dv == 64 ? dispatch_g<__nv_bfloat16, 2>(G, K6_ARGS)
                  : dispatch_g<__nv_bfloat16, 4>(G, K6_ARGS);
#undef K6_ARGS
}

const char* fd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// below the card's operations-per-byte balance.  The designs keep every
// load coalesced and write each output once; nothing is staged in
// shared memory beyond the per-block reduction.
//
// Numerics: every divide is IEEE (__fdiv_rn), codes round half to even
// (rintf), and the build passes -fmad=false; K3 also spells each
// product and sum as __fmul_rn/__fadd_rn, so it folds the users in the
// plain version's order with the same roundings and agrees with it bit
// for bit.  Subnormals are kept (no ftz).
//
// Every entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace {

constexpr int H_INF = 0, H_DWQ = 1, H_STEP = 2, H_DBAR = 3, H_LAM = 4;
constexpr int HEADER_LANES = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned F32_INF_BITS = 0x7f800000u;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long K1_CHUNK4 = 2048;   // float4s per K1 block: 8192 elems

__device__ __forceinline__ float safe_den(float v) {
  return (v > 0.0f) ? v : 1.0f;   // the jnp where(v > 0, v, 1.0), NaN -> 1
}

struct MaxOp { __device__ unsigned operator()(unsigned a, unsigned b) const { return max(a, b); } };
struct MinOp { __device__ unsigned operator()(unsigned a, unsigned b) const { return min(a, b); } };
struct AddOp { __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; } };

// Reduce one unsigned per thread over the block; the result is valid in
// thread 0.  Every thread of the block must call it.
template <typename Op>
__device__ unsigned block_reduce(unsigned v, unsigned identity, Op op) {
  __shared__ unsigned partial[WARPS];
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < WARPS) ? partial[lane] : identity;
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  }
  __syncthreads();   // partial[] is reused by the next call
  return v;
}

// ---------------------------------------------------------------- K1
// Grid (blocks per user, U).  The TPU grid ran its two phases in order
// on one core; here blocks run in any order, so each phase is a launch
// and the cross-block combine is an atomic on the header lane.  The
// max and min run on the f32 bit patterns as unsigned: every operand is
// non-negative after fabsf, where the unsigned order is the float order
// and a NaN (above +inf) stays the largest, as jnp.max propagates it.

__global__ void __launch_bounds__(THREADS)
k1_absmax(const float4* __restrict__ x, float* __restrict__ head,
          long long n4) {
  const int u = blockIdx.y;
  const float4* xu = x + (size_t)u * n4;
  const long long beg = (long long)blockIdx.x * K1_CHUNK4;
  const long long end = min(beg + K1_CHUNK4, n4);
  unsigned m = 0u;
  for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
    const float4 v = xu[i];
    m = max(m, __float_as_uint(fabsf(v.x)));
    m = max(m, __float_as_uint(fabsf(v.y)));
    m = max(m, __float_as_uint(fabsf(v.z)));
    m = max(m, __float_as_uint(fabsf(v.w)));
  }
  m = block_reduce(m, 0u, MaxOp());
  if (threadIdx.x == 0) {
    atomicMax(reinterpret_cast<unsigned*>(head + (size_t)u * HEADER_LANES + H_INF), m);
    // phase 2 min starts at +inf; the next launch is ordered after us
    if (blockIdx.x == 0) head[(size_t)u * HEADER_LANES + H_DWQ] = __uint_as_float(F32_INF_BITS);
  }
}

__global__ void __launch_bounds__(THREADS)
k1_threshold(const float4* __restrict__ x, float* __restrict__ head,
             long long n4, long long d_valid, float lam) {
  const int u = blockIdx.y;
  const float4* xu = x + (size_t)u * n4;
  float* h = head + (size_t)u * HEADER_LANES;
  const float safe_inf = safe_den(h[H_INF]);
  const long long beg = (long long)blockIdx.x * K1_CHUNK4;
  const long long end = min(beg + K1_CHUNK4, n4);
  unsigned mn = F32_INF_BITS, cnt = 0u;
  for (long long i = beg + threadIdx.x; i < end; i += THREADS) {
    const float4 v = xu[i];
    const float a[4] = {fabsf(v.x), fabsf(v.y), fabsf(v.z), fabsf(v.w)};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // the same per-element division as the plain version, not
      // |x| >= lam * inf, which rounds differently
      if (__fdiv_rn(a[k], safe_inf) >= lam && 4 * i + k < d_valid) {
        mn = min(mn, __float_as_uint(a[k]));
        ++cnt;
      }
    }
  }
  mn = block_reduce(mn, F32_INF_BITS, MinOp());
  cnt = block_reduce(cnt, 0u, AddOp());
  if (threadIdx.x == 0 && cnt) {
    atomicMin(reinterpret_cast<unsigned*>(h + H_DWQ), mn);
    // integer partial counts below 2**24 add exactly in f32, in any order
    atomicAdd(h + H_DBAR, (float)cnt);
  }
}

// ---------------------------------------------------------------- K2
// One warp per 128-lane row; lane j holds element 32c + j in step c, so
// the warp ballot over the predicate IS packed word c of the sign or hi
// plane.  Codes of `per` neighbouring lanes share a word: each lane
// shifts its code into its slot and an xor-shuffle tree ORs the slots.

__global__ void __launch_bounds__(THREADS)
k2_emit(const float* __restrict__ x, const float* __restrict__ head,
        unsigned* __restrict__ signs, unsigned* __restrict__ hi,
        unsigned* __restrict__ codes, long long rows, long long W,
        long long d_valid, int bw, float levels, int anchored) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;                 // warp-uniform
  const int lane = threadIdx.x & 31;
  const long long u = row / W, r = row - u * W;
  const float* h = head + u * HEADER_LANES;
  const float dwq = h[H_DWQ], lam = h[H_LAM];
  const float safe_inf = safe_den(h[H_INF]);
  const float safe_step = safe_den(h[H_STEP]);
  const float* xr = x + row * 128;
  const int per = 32 / bw, cpr = 4 * bw, slot = lane % per;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int e = 32 * c + lane;
    const float v = xr[e];
    const float a = fabsf(v);
    bool hb = anchored ? (a >= dwq) : (__fdiv_rn(a, safe_inf) >= lam);
    hb = hb && (r * 128 + e < d_valid);
    const unsigned sw = __ballot_sync(FULL, v > 0.0f);
    const unsigned hw = __ballot_sync(FULL, hb);
    if (lane == 0) {
      signs[row * 4 + c] = sw;
      hi[row * 4 + c] = hw;
    }
    // zeroed off the hi set, clamped to the grid top so an
    // underestimated anchor never spills into the neighbouring slot
    float code = rintf(__fdiv_rn(__fsub_rn(a, dwq), safe_step));
    code = fminf(hb ? code : 0.0f, levels);
    unsigned word = ((unsigned)code) << (slot * bw);
    for (int o = 1; o < per; o <<= 1) word |= __shfl_xor_sync(FULL, word, o);
    if (slot == 0) codes[row * cpr + e / per] = word;
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

}  // namespace

extern "C" {

// K1.  x: [U, W, 128] f32 (16-byte aligned); head: [U, 8] f32 zeroed.
int mr_reduce(const float* x, float* head, int U, long long W,
              long long d_valid, float lam, void* stream) {
  if (U < 1 || U > 65535 || W < 1) return (int)cudaErrorInvalidValue;
  const long long n4 = W * 32;
  const dim3 grid((unsigned)((n4 + K1_CHUNK4 - 1) / K1_CHUNK4), (unsigned)U);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  k1_absmax<<<grid, THREADS, 0, s>>>(x4, head, n4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k1_threshold<<<grid, THREADS, 0, s>>>(x4, head, n4, d_valid, lam);
  return (int)cudaGetLastError();
}

// K2.  x: [U, W, 128] f32; head: [U, 8] f32 -> signs, hi: [U, W, 4] u32,
// codes: [U, W, 4 * bw] u32.
int mr_emit(const float* x, const float* head, unsigned* signs,
            unsigned* hi, unsigned* codes, int U, long long W,
            long long d_valid, int b, int anchored, void* stream) {
  const int bw = code_width(b);
  if (U < 1 || W < 1 || bw < 0 || b < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)U * W;
  const float levels = (float)((1 << b) - 1);
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  k2_emit<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, head, signs, hi, codes, rows, W, d_valid, bw, levels, anchored);
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

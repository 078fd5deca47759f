// Sign-plane wire kernels K4-K5 for Hopper (sm_90a), plain C interface
// for ctypes.  Each replaces a Pallas kernel of the JAX package
// (src/repro/kernels/quant_pack.py) and computes what its plain PyTorch
// version (src/repro_torch/kernels/ref.py) computes:
//
//   K4 qp_signpack             <- signpack (_signpack_kernel): the
//                                 1-bit sign plane, bit j of word c =
//                                 x[32c + j] > 0
//   K5 qp_sign_dequant_reduce  <- sign_dequant_reduce
//                                 (_sign_dequant_reduce_kernel):
//                                 sum_g scale_g * (bit ? +1 : -1)
//
// Both are bound by device memory: K4 reads 4 bytes and does one
// compare per element and writes 1 bit; K5 reads 1 bit per peer and
// element and writes 4 bytes.  Neither needs shared memory.
//
// K4: one warp per 128-lane row.  Lane j holds element 32c + j in step
// c, so the warp ballot over x > 0 IS packed word c; each step's load is
// one coalesced 128-byte line.  Lanes 0-3 then store the row's four
// words as one 16-byte segment.  x > 0 is false for -0.0, +0.0 and NaN
// and true for a positive subnormal (no ftz in the build).
//
// K5: one thread per output element (w, l), word c = l / 32, bit l % 32.
// The threads of a warp share (w, c), so each word load is a broadcast.
// The peers fold left to right, acc = acc + (bit ? s_g : -s_g), with
// __fadd_rn (and -fmad=false in the build): the plain version's order
// and roundings, so the two agree bit for bit.
//
// Every entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// ---------------------------------------------------------------- K4
__global__ void __launch_bounds__(THREADS)
k4_signpack(const float* __restrict__ x, unsigned* __restrict__ words,
            long long rows) {
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;                 // warp-uniform
  const int lane = threadIdx.x & 31;
  const float* xr = x + row * 128;
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = xr[32 * c + lane];
  unsigned mine = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned w = __ballot_sync(FULL, v[c] > 0.0f);
    if (lane == c) mine = w;
  }
  if (lane < 4) words[row * 4 + lane] = mine;
}

// ---------------------------------------------------------------- K5
__global__ void __launch_bounds__(THREADS)
k5_sign_dequant_reduce(const unsigned* __restrict__ words,
                       const float* __restrict__ scales,
                       float* __restrict__ out, int G, long long W) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
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

}  // namespace

extern "C" {

// K4.  x: [rows, 128] f32 -> words: [rows, 4] u32.
int qp_signpack(const float* x, unsigned* words, long long rows,
                void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  k4_signpack<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, words, rows);
  return (int)cudaGetLastError();
}

// K5.  words: [G, W, 4] u32; scales: [G] f32 -> out: [W, 128] f32.
int qp_sign_dequant_reduce(const unsigned* words, const float* scales,
                           float* out, int G, long long W, void* stream) {
  if (G < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long n = W * 128;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  k5_sign_dequant_reduce<<<blocks, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      words, scales, out, G, W);
  return (int)cudaGetLastError();
}

const char* qp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// element and writes 4 bytes.
//
// K4: one warp per 128-lane row.  Lane j holds element 32c + j in step
// c, so the warp ballot over x > 0 IS packed word c; each step's load is
// one coalesced 128-byte line.  Lanes 0-3 then store the row's four
// words as one 16-byte segment.  x > 0 is false for -0.0, +0.0 and NaN
// and true for a positive subnormal (no ftz in the build).
//
// K5: K5_LANES = 16 lanes serve a row, so a warp serves two rows and a
// lane owns 8 consecutive outputs: bits sh..sh+7 of one word, written
// with two 16-byte stores (a row's 512 bytes coalesced).  Each warp
// stages its own rows' words in a ring of K5_STAGES stages in shared
// memory: stage k holds peers 16k..16k+15, one 16-byte cp.async a lane
// (a peer's words for the warp's two rows are 32 contiguous bytes, one
// sector), the stage's scales beside them.  Warps wait on their own
// copies (cp.async.wait_group, __syncwarp) and never on each other; a
// block is 4 warps (K5_ROWS = 8 rows: 480 blocks at W = 3840, all
// resident at once; one-warp blocks take 0.7 us longer at G = 1, in
// block launches, tools/probe_wire_kernels.py), and any G fits.  The
// grid depends on the shapes alone and the kernel allocates nothing (a
// CUDA graph can capture it).
//
// K5 moves 4.4 MB at the signplane round's shape (G = 40, W = 3840) but
// does 2 instructions an output and peer: it is bound by instruction
// issue, not bytes.  The fold is acc + (bit ? s : -s), peers in
// ascending order, with -fmad=false: an add or a subtract under a
// predicate (x - s is x + (-s) in IEEE arithmetic), the predicates of 7
// bits set by one instruction (R2P), where a select would take an ALU
// slot an output.  The fold starts from the first term itself, not from
// 0.0 (0.0 + -0.0 would turn a G = 1 result of -0.0 into +0.0), and
// negates that term as the card's arithmetic does (a NaN scale gives the
// canonical NaN 0x7fffffff, as the plain version's torch.neg does on the
// card): the plain version's order and roundings, so the two agree bit
// for bit.  The wrapper plans the launch (quant_pack.sign_reduce_plan,
// whose staging_order is the twin of the copies below) and the entry
// point refuses any other plan.
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
constexpr int K5_LANES = 16;                // lanes a row
constexpr int K5_ROWS = 8;                  // rows a block
constexpr int K5_STAGES = 4;                // stages in flight a warp
constexpr int K5_OUT = 128 / K5_LANES;      // outputs a lane
constexpr int K5_RPW = 32 / K5_LANES;       // rows a warp
constexpr int K5_CHUNK = K5_LANES;          // peers a stage: a piece a lane
constexpr int K5_WARPS = K5_ROWS / K5_RPW;
constexpr unsigned F32_NAN_CANON_BITS = 0x7fffffffu;
static_assert(K5_ROWS % K5_RPW == 0 && K5_OUT % 4 == 0,
              "whole warps a block, whole float4 stores a lane");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(reinterpret_cast<unsigned long long>(src))
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(reinterpret_cast<unsigned long long>(src))
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// acc + (bit ? s : -s), as one add or one subtract under a predicate
// (x - s is x + (-s) in IEEE arithmetic, NaN and signed zeros included).
// A select would take an ALU slot an output; the compiler sets the
// predicates of several bits with one instruction (R2P).
__device__ __forceinline__ float fold_bit(float acc, float s, unsigned bit) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ne.u32 p, %2, 0;\n\t"
      "@p add.rn.f32 %0, %0, %1;\n\t"
      "@!p sub.rn.f32 %0, %0, %1;\n\t}"
      : "+f"(acc) : "f"(s), "r"(bit));
  return acc;
}

// A warp's ring of stages: stage k holds peers k*K5_CHUNK.. of its rows.
struct K5Ring {
  uint4 words[K5_STAGES][K5_CHUNK][K5_RPW];
  float scale[K5_STAGES][K5_CHUNK];
};

__global__ void __launch_bounds__(K5_WARPS * 32)
k5_sign_dequant_reduce(const uint4* __restrict__ words,
                       const float* __restrict__ scales,
                       float* __restrict__ out, int G, long long W) {
  __shared__ K5Ring rings[K5_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rw = (long long)blockIdx.x * K5_ROWS + warp * K5_RPW;
  if (rw >= W) return;                    // warp-uniform; no block barrier
  K5Ring& ring = rings[warp];
  const int chunks = (G + K5_CHUNK - 1) / K5_CHUNK;

  // stage k: lane i copies peer k*K5_CHUNK + i/K5_RPW of row rw + i%K5_RPW
  // (the warp's rows of one peer are contiguous), lanes i < K5_CHUNK the
  // stage's scales; every lane commits one group a stage, empty or not,
  // so the waits count stages
  const int pg = lane / K5_RPW, pq = lane % K5_RPW;
  const bool pq_ok = rw + pq < W;
  auto issue = [&](int k) {
    const int g = k * K5_CHUNK + pg, buf = k % K5_STAGES;
    if (g < G && pq_ok) {
      cp_async16(&ring.words[buf][pg][pq], words + (long long)g * W + rw + pq);
    }
    if (lane < K5_CHUNK && k * K5_CHUNK + lane < G) {
      cp_async4(&ring.scale[buf][lane], scales + k * K5_CHUNK + lane);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // lane l of row q of the warp folds outputs l*K5_OUT.. of row rw + q:
  // bits sh.. of word c
  const int q = lane / K5_LANES, l = lane % K5_LANES;
  const int c = l * K5_OUT / 32, sh = l * K5_OUT % 32;
  float a[K5_OUT];
  auto term = [&](unsigned w, float s) {
#pragma unroll
    for (int i = 0; i < K5_OUT; ++i) a[i] = fold_bit(a[i], s, w & (1u << i));
  };

#pragma unroll
  for (int k = 0; k < K5_STAGES - 1; ++k) issue(k);
  for (int k = 0; k < chunks; ++k) {
    issue(k + K5_STAGES - 1);
    cp_async_wait<K5_STAGES - 1>();
    __syncwarp();                       // stage k has landed for every lane
    const int buf = k % K5_STAGES, n = min(K5_CHUNK, G - k * K5_CHUNK);
    const unsigned* wp =
        reinterpret_cast<const unsigned*>(&ring.words[buf][0][q]) + c;
    const float* sp = ring.scale[buf];
    constexpr int STEP = K5_RPW * 4;      // words from peer to peer
    if (k == 0) {
      // the fold starts from the first term itself; its negation is the
      // card's arithmetic one (a NaN scale gives the canonical NaN, as
      // the plain version's torch.neg does there), since no add follows
      // it when G = 1
      const float s = sp[0];
      const float ns = (s != s) ? __uint_as_float(F32_NAN_CANON_BITS) : -s;
      const unsigned w = wp[0] >> sh;
#pragma unroll
      for (int i = 0; i < K5_OUT; ++i) a[i] = ((w >> i) & 1u) ? s : ns;
#pragma unroll 4
      for (int j = 1; j < n; ++j) term(wp[j * STEP] >> sh, sp[j]);
    } else if (n == K5_CHUNK) {         // a full stage, unrolled whole
#pragma unroll
      for (int j = 0; j < K5_CHUNK; ++j) term(wp[j * STEP] >> sh, sp[j]);
    } else {
#pragma unroll 4
      for (int j = 0; j < n; ++j) term(wp[j * STEP] >> sh, sp[j]);
    }
    __syncwarp();                       // before a later issue refills buf
  }
  if (rw + q < W) {
    float4* o = reinterpret_cast<float4*>(out + (rw + q) * 128 + l * K5_OUT);
#pragma unroll
    for (int i = 0; i < K5_OUT / 4; ++i) {
      o[i] = make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
    }
  }
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

// K5.  words: [G, W, 4] u32; scales: [G] f32 -> out: [W, 128] f32; words
// and out 16-byte aligned.  rows, chunk, blocks: the wrapper's plan
// (K5_ROWS rows a block, K5_CHUNK peers a stage, ceil(W / K5_ROWS)
// blocks); any other is refused.
int qp_sign_dequant_reduce(const unsigned* words, const float* scales,
                           float* out, int G, long long W, int rows,
                           int chunk, long long blocks, void* stream) {
  if (G < 1 || W < 1 || rows != K5_ROWS || chunk != K5_CHUNK ||
      blocks != (W + K5_ROWS - 1) / K5_ROWS || blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  k5_sign_dequant_reduce<<<(unsigned)blocks, K5_WARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(words), scales, out, G, W);
  return (int)cudaGetLastError();
}

const char* qp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// K1: batched full-QSketch register update on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/qsketch_update.py:_qsketch_kernel (entry
// qsketch_update_padded). For every (element i, register j) pair:
//   bits = murmur3(lo_i, hi_i, j; salt_h)
//   e    = -ln(u(bits))
//   y    = clip(floor(log2 w_i - log2 e), r_min, r_max)
// then R[j] = max(R[j], max_i y_ij).
//
// Bound on the H100: operations. A batch of B elements at m registers is
// B*m independent hash + two-log evaluations (16.8 M pairs for B = 65,536,
// m = 256) against ~20 bytes read per element, so the integer and SFU
// pipes, not HBM, set the time.
//
// Design: the TPU grid keeps one register block resident in VMEM while the
// batch streams through it in order; Hopper blocks run in no order, so each
// block takes a (batch chunk x register tile) and reduces its chunk in
// registers, then folds into the int32 scratch row with one atomicMax per
// register (CUDA has no 8-bit atomics; the wrapper converts to int8).
// The first two murmur rounds depend only on the element, so each block
// mixes (lo, hi) once per element into shared memory and every register
// thread runs only the third round and the finalizer. The arithmetic is the
// plain version's, operation for operation: native uint32_t murmur, logf /
// log2f / floorf (no fast-math intrinsics), so y agrees bit for bit with
// the plain PyTorch version on the card. A NaN y (possible only for a
// masked or zero-weight row) clips to r_min.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kFmix1 = 0x85EBCA6Bu;
constexpr uint32_t kFmix2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kThreads = 256;  // registers per block, one per thread
constexpr int kRows = 256;     // batch rows per block

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t w, uint32_t i) {
  uint32_t k = w * kC1;
  k = rotl32(k, 15);
  k *= kC2;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + (0xE6546B64u + 0x9E3779B1u * i);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kFmix1;
  h ^= h >> 13;
  h *= kFmix2;
  h ^= h >> 16;
  return h;
}

__global__ void qsketch_update_kernel(const int64_t* __restrict__ lo,
                                      const int64_t* __restrict__ hi,
                                      const float* __restrict__ log2w,
                                      int64_t batch, int m, uint32_t salt,
                                      int r_min, int r_max,
                                      int* __restrict__ regs) {
  __shared__ uint32_t s_h[kRows];
  __shared__ float s_lw[kRows];
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int64_t left = batch - row0;
  const int rows = left < kRows ? (int)left : kRows;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    uint32_t h = kGolden ^ salt;
    h = mix_word(h, (uint32_t)lo[row0 + r], 0u);
    h = mix_word(h, (uint32_t)hi[row0 + r], 1u);
    s_h[r] = h;
    s_lw[r] = log2w[row0 + r];
  }
  __syncthreads();
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const float lo_clip = (float)r_min;
  const float hi_clip = (float)r_max;
  float best = lo_clip;
  for (int r = 0; r < rows; ++r) {
    const uint32_t bits = fmix32(mix_word(s_h[r], (uint32_t)j, 2u));
    const float u = (float)(bits >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
    const float e = -logf(u);
    float y = floorf(s_lw[r] - log2f(e));
    y = fminf(fmaxf(y, lo_clip), hi_clip);
    best = fmaxf(best, y);
  }
  atomicMax(regs + j, (int)best);
}

}  // namespace

// regs: int32[m] scratch holding the current registers; updated in place.
extern "C" int qsketch_update_launch(const void* lo, const void* hi,
                                     const void* log2w, long long batch,
                                     int m, unsigned int salt, int r_min,
                                     int r_max, void* regs, void* stream) {
  const dim3 grid((unsigned)((batch + kRows - 1) / kRows),
                  (unsigned)((m + kThreads - 1) / kThreads));
  qsketch_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)lo, (const int64_t*)hi, (const float*)log2w,
      (int64_t)batch, m, (uint32_t)salt, r_min, r_max, (int*)regs);
  return (int)cudaGetLastError();
}

extern "C" const char* qsketch_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

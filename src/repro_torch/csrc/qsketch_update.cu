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
// thread runs only the third round and the finalizer. The hash and the
// quantization are qsketch_y.cuh's, shared with K6: the plain version's
// arithmetic operation for operation, so y agrees bit for bit with the
// plain PyTorch version on the card. A NaN y (possible only for a masked or
// zero-weight row) clips to r_min.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qsketch_y.cuh"

namespace {

constexpr int kThreads = 256;  // registers per block, one per thread
constexpr int kRows = 256;     // batch rows per block

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
    s_h[r] = qsketch_y::element_prefix(salt, (uint32_t)lo[row0 + r], (uint32_t)hi[row0 + r]);
    s_lw[r] = log2w[row0 + r];
  }
  __syncthreads();
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const float lo_clip = (float)r_min;
  const float hi_clip = (float)r_max;
  float best = lo_clip;
  for (int r = 0; r < rows; ++r) {
    best = fmaxf(best, qsketch_y::quantized_y(s_h[r], s_lw[r], (uint32_t)j, lo_clip, hi_clip));
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

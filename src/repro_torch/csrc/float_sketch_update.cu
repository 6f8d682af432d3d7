// K5: batched float min-sketch update of the paper's baselines (LM) on
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/qsketch_update.py:_float_kernel (entry
// float_sketch_update_padded). For every (element i, register j) pair:
//   e    = -ln(u(murmur3(lo_i, hi_i, j; salt_h)))
//   r_ij = e / w_i  where w_i > 0, else FLT_MAX (padding and masked rows
//          carry w = -1; a NaN w fails the test too)
// then R[j] = min(R[j], min_i r_ij).
//
// Bound on the H100: operations. A batch of B elements at m registers is
// B*m hash + log + division evaluations (16.8 M pairs for B = 65,536,
// m = 256) against ~20 bytes read per element.
//
// Design: K1's. The TPU grid keeps one register block resident in VMEM while
// the batch streams through it in order; here each block takes a (batch
// chunk x register tile), reduces its chunk in registers, then folds into
// the float32 registers with one atomicMin per register. CUDA has no float
// atomicMin, but every r is >= 0 or FLT_MAX, and for non-negative IEEE
// floats the int32 bit patterns order as the values do, so an int32
// atomicMin on the bits is a float min. The one exception is -0.0 (u
// rounds to 1.0, so e = -0.0; ROADMAP queue 3), whose bits are INT_MIN:
// adding +0.0 maps it to +0.0 before the atomic. The incoming registers
// hold values >= 0 (or -0.0 from the plain version, which equals +0.0).
// The first two murmur rounds run once per row into shared memory; each
// register thread runs the third round, the finalizer and -ln u
// (qsketch_y.cuh, shared with K1, K6 and K8), then a true division e / w —
// never e * (1/w), which rounds differently — so r agrees bit for bit with
// the plain PyTorch version on the card.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "qsketch_y.cuh"

namespace {

constexpr int kThreads = 256;  // registers per block, one per thread
constexpr int kRows = 256;     // batch rows per block

__global__ void float_sketch_update_kernel(const int64_t* __restrict__ lo,
                                           const int64_t* __restrict__ hi,
                                           const float* __restrict__ w,
                                           int64_t batch, int m, uint32_t salt,
                                           float* __restrict__ regs) {
  __shared__ uint32_t s_h[kRows];
  __shared__ float s_w[kRows];
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int64_t left = batch - row0;
  const int rows = left < kRows ? (int)left : kRows;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    s_h[r] = qsketch_y::element_prefix(salt, (uint32_t)lo[row0 + r], (uint32_t)hi[row0 + r]);
    s_w[r] = w[row0 + r];
  }
  __syncthreads();
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float best = FLT_MAX;
  for (int r = 0; r < rows; ++r) {
    const float wr = s_w[r];
    if (wr > 0.0f) best = fminf(best, qsketch_y::neg_log_u(s_h[r], (uint32_t)j) / wr);
  }
  atomicMin((int*)regs + j, __float_as_int(best + 0.0f));
}

}  // namespace

// regs: float32[m] registers, updated in place.
extern "C" int float_sketch_update_launch(const void* lo, const void* hi, const void* w,
                                          long long batch, int m, unsigned int salt,
                                          void* regs, void* stream) {
  const dim3 grid((unsigned)((batch + kRows - 1) / kRows),
                  (unsigned)((m + kThreads - 1) / kThreads));
  float_sketch_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)lo, (const int64_t*)hi, (const float*)w, (int64_t)batch, m,
      (uint32_t)salt, (float*)regs);
  return (int)cudaGetLastError();
}

extern "C" const char* float_sketch_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K8: per-element pool placement of the register-sharing virtual tier on
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/virtual_pool_update.py:_pool_route_kernel
// (entry virtual_pool_route_padded). For every element i:
//   j = hash_mod((lo_i, hi_i), salt_g, m_v)               register choice
//   y = floor(log2 w_i - log2(-ln u(lo_i, hi_i, j; salt_h)))
//   y = min(y, r_max); a NaN or -inf y becomes r_min      (qsketch_dyn's y:
//                                                          no r_min clip)
//   p = hash_mod((t_lo_i, t_hi_i, j), salt_pool, M)       pool slot
//
// Bound on the H100: bytes. Each element reads four int64 id words and a
// float32 log2 w and writes an int32 slot (M < 2^31) and an int32 value
// (44 bytes) for three murmur hashes, two logs and the quantization (94
// operations, counted in chip_smoke.py), far below the card's ratio of
// operations to bytes.
//
// Design: the TPU kernel is a (B, 1) column sweep with no state read; here
// one thread owns one element, so loads and stores are coalesced and there
// is nothing to reduce. The hash and -ln u are qsketch_y.cuh's, shared with
// K1, K5 and K6, so p and y agree bit for bit with the plain PyTorch
// version on the card. y is NOT K1's clipped value: qsketch_dyn clamps at
// r_max only (a NaN survives the clamp) and maps what is not finite to
// r_min, which the code below spells out in that order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qsketch_y.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void virtual_pool_route_kernel(const int64_t* __restrict__ lo,
                                          const int64_t* __restrict__ hi,
                                          const int64_t* __restrict__ t_lo,
                                          const int64_t* __restrict__ t_hi,
                                          const float* __restrict__ log2w,
                                          int64_t batch, uint32_t salt_g,
                                          uint32_t salt_h, uint32_t salt_pool,
                                          uint32_t m_v, uint32_t pool_size,
                                          int r_min, int r_max,
                                          int32_t* __restrict__ p,
                                          int32_t* __restrict__ y) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  const uint32_t elo = (uint32_t)lo[i];
  const uint32_t ehi = (uint32_t)hi[i];
  const uint32_t j = qsketch_y::hash_mod(qsketch_y::hash2(salt_g, elo, ehi), m_v);
  const float raw = qsketch_y::raw_y(qsketch_y::element_prefix(salt_h, elo, ehi), log2w[i], j);
  float v;
  if (isnan(raw)) {
    v = (float)r_min;
  } else {
    v = fminf(raw, (float)r_max);
    if (isinf(v)) v = (float)r_min;
  }
  const uint32_t h = qsketch_y::mix_word(
      qsketch_y::element_prefix(salt_pool, (uint32_t)t_lo[i], (uint32_t)t_hi[i]), j, 2u);
  p[i] = (int32_t)qsketch_y::hash_mod(qsketch_y::fmix32(h), pool_size);
  y[i] = (int32_t)v;
}

}  // namespace

// p: int32[batch] pool slots, y: int32[batch] quantized values (outputs).
extern "C" int virtual_pool_route_launch(const void* lo, const void* hi, const void* t_lo,
                                         const void* t_hi, const void* log2w, long long batch,
                                         unsigned int salt_g, unsigned int salt_h,
                                         unsigned int salt_pool, unsigned int m_v,
                                         unsigned int pool_size, int r_min, int r_max,
                                         void* p, void* y, void* stream) {
  const unsigned blocks = (unsigned)((batch + kThreads - 1) / kThreads);
  virtual_pool_route_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)lo, (const int64_t*)hi, (const int64_t*)t_lo, (const int64_t*)t_hi,
      (const float*)log2w, (int64_t)batch, (uint32_t)salt_g, (uint32_t)salt_h,
      (uint32_t)salt_pool, (uint32_t)m_v, (uint32_t)pool_size, r_min, r_max, (int32_t*)p,
      (int32_t*)y);
  return (int)cudaGetLastError();
}

extern "C" const char* virtual_pool_route_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

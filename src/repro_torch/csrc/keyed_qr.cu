// K2 and K3: the QSketch-Dyn update probability q_R on Hopper (sm_90a).
//
//   q_i = 1 - (1/m) * sum_k T[k] * exp(-w_i * s_k),   s_k = 2^-(k + r_min + 1)
//
// Replaces:
//   K2 src/repro/kernels/qdyn_qr.py:_qr_kernel (entry qdyn_qr_padded) — one
//      histogram T for the whole batch;
//   K3 src/repro/kernels/dyn_array_update.py:_keyed_qr_kernel (entry
//      dyn_array_qr_padded) — T is row keys[i] of the int32[K, 2^b]
//      histogram block, read by the kernel itself.
//
// Bounds on the H100: K2 moves a weight in and a q out per element and does
// one exp per element and occupied bin. At the main path's occupancy (about
// ten occupied bins) it is bound by bytes; it becomes bound by operations
// only when most of the 2^b bins are occupied. K3 is bound by bytes: each
// element's key row is 2^b int32 (1 KiB at b = 8), gathered from a block
// that lives in HBM (1 GiB at K = 2^20).
//
// Design: one warp per element; lane l takes bins l, l+32, ... so a warp
// reads its key's row as coalesced 128-byte segments straight from the
// int32 block (the TPU front first builds a [B, 2^b] f32 gather of the rows
// in HBM; here that copy never exists). The scales sit in shared memory,
// and for K2 the shared histogram too. Bins with a zero count are skipped:
// they add an exact 0 to the sum. A butterfly shuffle reduces the lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxBins = 256;

template <bool kKeyed>
__global__ void qr_kernel(const float* __restrict__ w,
                          const int* __restrict__ hists,
                          const int64_t* __restrict__ keys,
                          const float* __restrict__ scales, int64_t batch,
                          int64_t k_rows, int nb, float m, float* __restrict__ q) {
  __shared__ float s_scale[kMaxBins];
  __shared__ float s_hist[kKeyed ? 1 : kMaxBins];
  for (int k = threadIdx.x; k < nb; k += blockDim.x) {
    s_scale[k] = scales[k];
    if (!kKeyed) s_hist[k] = (float)hists[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= batch) return;  // warp-uniform
  const float wi = w[i];
  // Keys are clipped to [0, K), as the JAX front clips them: a stray key
  // reads row 0 or K-1, never memory outside the block.
  int64_t key = kKeyed ? keys[i] : 0;
  key = key < 0 ? 0 : (key >= k_rows ? k_rows - 1 : key);
  const int* row = hists + key * nb;
  float acc = 0.0f;
  for (int k = lane; k < nb; k += 32) {
    const float t = kKeyed ? (float)row[k] : s_hist[k];
    if (t != 0.0f) acc += t * expf(-wi * s_scale[k]);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) q[i] = 1.0f - acc / m;
}

unsigned blocks_for(long long batch) {
  return (unsigned)((batch + kWarps - 1) / kWarps);
}

}  // namespace

// K2: hist int32[nb] shared by every element.
extern "C" int qdyn_qr_launch(const void* w, const void* hist,
                              const void* scales, long long batch, int nb,
                              int m, void* q, void* stream) {
  qr_kernel<false><<<blocks_for(batch), kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const int*)hist, nullptr, (const float*)scales,
      (int64_t)batch, 1, nb, (float)m, (float*)q);
  return (int)cudaGetLastError();
}

// K3: hists int32[K, nb]; element i reads row keys[i] (int64, clipped to [0, K)).
extern "C" int keyed_qr_launch(const void* w, const void* hists,
                               const void* keys, const void* scales,
                               long long batch, long long k_rows, int nb, int m,
                               void* q, void* stream) {
  qr_kernel<true><<<blocks_for(batch), kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const int*)hists, (const int64_t*)keys,
      (const float*)scales, (int64_t)batch, (int64_t)k_rows, nb, (float)m, (float*)q);
  return (int)cudaGetLastError();
}

extern "C" const char* keyed_qr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

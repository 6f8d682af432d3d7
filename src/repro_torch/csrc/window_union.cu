// K7: fused epoch-window union + per-row full register histogram on Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/window_union.py:_window_union_kernel (entry
// window_union_padded). For every tenant row k of an int8[E, K, m] epoch
// ring: the max-union of the planes e whose age (head - e) mod E is below
// the window w, and the FULL histogram of that union row (bin v counts the
// registers equal to v + r_min, untouched r_min registers in bin 0, so
// each row sums to m) — exactly estimators.histogram of the union row,
// which the histogram MLE then reads. The union itself is not emitted
// (the JAX front discards it too).
//
// Bound on the H100: bytes. The w included planes are read once (w*K*m
// bytes) and the histogram is written once (K*2^b*4 bytes). At K = 2^20,
// m = 256, 2^b = 256 that is 1 GiB of histogram against w/4 GiB of
// registers: the histogram write, not the register read, is most of the
// bytes (0.64 ms at 3.35 TB/s for w = 4).
//
// Design. The TPU grid is (k_block, E) with the epochs innermost and the
// union tile resident across the sweep. Here one warp owns a row and loops
// over the epochs itself; each lane keeps its slice of the union in
// registers (signed byte-wise max on 32-bit words, __vmaxs4, where m is a
// multiple of 4 and the ring is 4-byte aligned; bytes otherwise). The
// include flags come from the ring's head, read on the device, so the read
// needs no host sync; an excluded plane is simply not read, which saves
// (E - w)/E of the register traffic. The row's histogram is built in
// shared memory (each lane counts its r_min registers itself, so the
// common untouched value does not serialize the shared atomics), then
// written with one coalesced pass of 2^b int32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kMaxBins = 256;
constexpr int kMaxWords = 16;  // per lane: m <= 2048 on the word path
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void count_byte(int v, int r_min, int* hist, int* n_min) {
  if (v == r_min) {
    ++*n_min;
  } else {
    atomicAdd(hist + (v - r_min), 1);
  }
}

__global__ void window_union_kernel(const int8_t* __restrict__ regs,
                                    const int* __restrict__ head_ptr,
                                    int n_epochs, int64_t k, int m, int w,
                                    int r_min, int nb, int words,
                                    int* __restrict__ hist_out) {
  __shared__ int s_hist[kWarps][kMaxBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= k) return;  // whole warps leave together
  int* hist = s_hist[warp];
  for (int i = lane; i < nb; i += 32) hist[i] = 0;
  __syncwarp();

  const int head = *head_ptr;
  const int64_t plane = k * (int64_t)m;
  int n_min = 0;
  if (words) {
    // m % 4 == 0 and a 4-byte aligned ring: lane owns words lane, lane+32, ...
    const int n_words = m >> 2;
    const uint32_t rmin4 = 0x01010101u * (uint32_t)(r_min & 0xFF);
    uint32_t acc[kMaxWords];
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) acc[i] = rmin4;
    for (int e = 0; e < n_epochs; ++e) {
      const int age = ((head - e) % n_epochs + n_epochs) % n_epochs;
      if (age >= w) continue;
      const uint32_t* src = (const uint32_t*)(regs + e * plane + row * m);
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) {
        const int wi = lane + 32 * i;
        if (wi < n_words) acc[i] = __vmaxs4(acc[i], __ldg(src + wi));
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) {
      if (lane + 32 * i < n_words) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          count_byte((int)(int8_t)((acc[i] >> (8 * b)) & 0xFFu), r_min, hist, &n_min);
        }
      }
    }
  } else {
    for (int j = lane; j < m; j += 32) {
      int v = r_min;
      for (int e = 0; e < n_epochs; ++e) {
        const int age = ((head - e) % n_epochs + n_epochs) % n_epochs;
        if (age < w) v = max(v, (int)regs[e * plane + row * m + j]);
      }
      count_byte(v, r_min, hist, &n_min);
    }
  }
  for (int off = 16; off > 0; off >>= 1) n_min += __shfl_xor_sync(kAll, n_min, off);
  __syncwarp();
  if (lane == 0) hist[0] += n_min;
  __syncwarp();
  int* out = hist_out + row * nb;
  for (int i = lane; i < nb; i += 32) out[i] = hist[i];
}

}  // namespace

// regs: int8[E, K, m] ring; head: int32 scalar on the device (ring slot of
// the current epoch); w in [1, E]; hist: int32[K, nb] output (full
// histograms). The launcher takes the 32-bit word path where m % 4 == 0,
// m <= 2048 and the ring is 4-byte aligned, the byte path otherwise.
extern "C" int window_union_launch(const void* regs, const void* head,
                                   int n_epochs, long long k, int m, int w,
                                   int r_min, int nb, void* hist,
                                   void* stream) {
  if (nb > kMaxBins) return (int)cudaErrorInvalidValue;
  const int words = m % 4 == 0 && m <= 4 * 32 * kMaxWords &&
                    (uintptr_t)regs % 4 == 0;
  const unsigned blocks = (unsigned)((k + kWarps - 1) / kWarps);
  window_union_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const int8_t*)regs, (const int*)head, n_epochs, (int64_t)k, m, w, r_min,
      nb, words, (int*)hist);
  return (int)cudaGetLastError();
}

extern "C" const char* window_union_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

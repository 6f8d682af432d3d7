// K4: fused per-row bincount + fixed-iteration histogram MLE on Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/estimate.py:_estimate_kernel (entry
// estimate_rows_padded). For every register row: bincount the m int8
// registers into 2^b bins, then run exactly 30 steps of the rebased,
// safeguarded Newton of estimators.qsketch_mle (term for term as
// estimators._f_and_fprime), with the same degenerate fallbacks, and emit
// the unscaled (chat, stddev, converged) triple.
//
// Bound on the H100: bytes, for the register block it must read once
// (K*m int8: 256 MiB at K = 2^20, m = 256); the Newton work over the
// occupied bins is smaller at the main path's row occupancy.
//
// Design: one warp per row. The warp bincounts its row into a shared
// histogram with shared-memory atomics, then compacts the occupied bins
// into a list with a ballot, so each Newton step evaluates only occupied
// bins (a row holds few distinct register values). That is exact, not an
// approximation: for C >= 1e-18 every term of an empty bin is finite and
// adds an exact 0. Below that, an empty bin's term can overflow and make
// the sum NaN, as it does in the plain version and in the JAX kernel (0 *
// inf), which steers the safeguard; so once C drops under 1e-18 the warp
// evaluates every bin, exactly as the plain version does. The [K, 2^b]
// histogram block never exists in HBM. Sums run in another order than the
// plain version's, so results agree to float32 rounding, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxBins = 256;
constexpr int kIters = 30;
constexpr float kEpsZ = 1e-4f;
constexpr float kFullBelow = 1e-18f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float f_term(float c, float scale) {
  const float z = c * scale;
  const float zz = fminf(fmaxf(z, kEpsZ), 88.0f);
  return z < kEpsZ ? (1.0f / c - 0.5f * scale) : scale / expm1f(zz);
}

__device__ __forceinline__ float fp_term(float c, float scale) {
  const float z = c * scale;
  const float zz = fmaxf(z, kEpsZ);
  const float lsh = zz > 40.0f ? zz / 2.0f : logf(2.0f * sinhf(fminf(zz, 40.0f) / 2.0f));
  return z < kEpsZ ? -1.0f / (c * c) : -expf(2.0f * (logf(scale) - lsh));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

struct Row {
  const int* hist;     // shared, nb bins
  const float* scale;  // shared, rebased s_k
  const short* occ;    // shared, occupied bin indices
  int n_occ, nb, top;
};

__device__ __forceinline__ void add_bin(const Row& row, int k, float c, float& f, float& fp) {
  const float t = (float)row.hist[k];
  const float s = row.scale[k];
  float ft, fpt;
  if (k == 0) {
    ft = -s;
    fpt = 0.0f;
  } else if (k == row.top) {
    const float a = 2.0f * s;
    ft = f_term(c, a);
    fpt = fp_term(c, a);
  } else {
    ft = f_term(c, s) - s;
    fpt = fp_term(c, s);
  }
  f += t * ft;
  fp += t * fpt;
}

// Score and derivative at c, summed over the row's bins (warp-uniform).
__device__ __forceinline__ void score(const Row& row, float c, int lane, float& f, float& fp) {
  f = 0.0f;
  fp = 0.0f;
  if (c < kFullBelow) {
    for (int k = lane; k < row.nb; k += 32) add_bin(row, k, c, f, fp);
  } else {
    for (int i = lane; i < row.n_occ; i += 32) add_bin(row, row.occ[i], c, f, fp);
  }
  f = warp_sum(f);
  fp = warp_sum(fp);
}

__global__ void estimate_kernel(const int8_t* __restrict__ regs, int64_t k_rows,
                                int m, int nb, int r_min, int top,
                                float* __restrict__ chat,
                                float* __restrict__ stddev,
                                int* __restrict__ conv) {
  __shared__ int s_hist[kWarps][kMaxBins];
  __shared__ float s_scale[kWarps][kMaxBins];
  __shared__ short s_occ[kWarps][kMaxBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row_id = (int64_t)blockIdx.x * kWarps + warp;
  if (row_id >= k_rows) return;  // warp-uniform
  int* hist = s_hist[warp];
  float* scale = s_scale[warp];
  short* occ = s_occ[warp];

  for (int k = lane; k < nb; k += 32) hist[k] = 0;
  __syncwarp();
  const int8_t* r = regs + row_id * (int64_t)m;
  for (int i = lane; i < m; i += 32) {
    const int k = min(max((int)r[i] - r_min, 0), nb - 1);
    atomicAdd(hist + k, 1);
  }
  __syncwarp();

  // Rebase: delta = round(mean register value); the sum is an exact integer.
  int ksum = 0;
  for (int k = lane; k < nb; k += 32) ksum += hist[k] * (k + r_min);
  for (int off = 16; off > 0; off >>= 1) ksum += __shfl_xor_sync(kAll, ksum, off);
  const float fm = (float)m;
  const float delta = rintf((float)ksum / fm);

  // Rebased scales, the seed's denominator, and the occupied-bin list.
  float den = 0.0f;
  int n_occ = 0;
  for (int base = 0; base < nb; base += 32) {
    const int k = base + lane;
    const int t = k < nb ? hist[k] : 0;
    if (k < nb) {
      const float expo = fminf(fmaxf(delta - ((float)(k + r_min) + 1.0f), -126.0f), 126.0f);
      const float s = exp2f(expo);
      scale[k] = s;
      den += (float)t * s * 2.0f;
    }
    const unsigned mask = __ballot_sync(kAll, t > 0);
    if (t > 0) occ[n_occ + __popc(mask & ((1u << lane) - 1u))] = (short)k;
    n_occ += __popc(mask);
  }
  den = warp_sum(den);
  __syncwarp();

  const Row row{hist, scale, occ, n_occ, nb, top};
  const int t0 = hist[0];
  const bool degenerate = (t0 == m) || (hist[top] == m);
  float c = (fm - 1.0f) / fmaxf(den, 1e-30f);
  c = fminf(fmaxf(c, 1e-20f), 1e20f);

  float f, fp;
  if (!degenerate) {
    for (int it = 0; it < kIters; ++it) {
      score(row, c, lane, f, fp);
      const float g = fabsf(fp) > 0.0f ? fp : -1e-30f;
      float cn = c - f / g;
      cn = fminf(fmaxf(cn, c / 8.0f), c * 8.0f);
      c = fmaxf(cn, 1e-30f);
    }
  }
  score(row, c, lane, f, fp);
  const float g = fabsf(fp) > 0.0f ? fp : -1e-30f;
  const float sd = sqrtf(fmaxf(-1.0f / g, 0.0f));
  const float back = exp2f(delta);
  if (lane == 0) {
    chat[row_id] = t0 == m ? 0.0f : c * back;
    stddev[row_id] = sd * back;
    conv[row_id] = degenerate ? 0 : 1;
  }
}

}  // namespace

// regs int8[K, m] -> chat f32[K], stddev f32[K], conv int32[K] (unscaled).
extern "C" int estimate_launch(const void* regs, long long k_rows, int m,
                               int nb, int r_min, int top, void* chat,
                               void* stddev, void* conv, void* stream) {
  const unsigned blocks = (unsigned)((k_rows + kWarps - 1) / kWarps);
  estimate_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)regs, (int64_t)k_rows, m, nb, r_min, top, (float*)chat,
      (float*)stddev, (int*)conv);
  return (int)cudaGetLastError();
}

extern "C" const char* estimate_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

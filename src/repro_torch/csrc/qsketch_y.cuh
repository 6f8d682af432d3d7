// Device code shared by K1 (qsketch_update.cu), K5
// (float_sketch_update.cu), K6 (sketch_array_update.cu) and K8
// (virtual_pool_route.cu): the murmur3 rounds of hashing.hash_words,
// hash_mod, -ln u, and the quantized register value y of one (element,
// register) pair.
//
// The arithmetic is the plain PyTorch version's, operation for operation:
// native uint32_t murmur, logf / log2f / floorf (no fast-math intrinsics),
// so y agrees bit for bit with the plain version on the card.

#pragma once

#include <stdint.h>

namespace qsketch_y {

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;
constexpr uint32_t kFmix1 = 0x85EBCA6Bu;
constexpr uint32_t kFmix2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;

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

// The first two rounds, which depend only on the element id (lo, hi).
__device__ __forceinline__ uint32_t element_prefix(uint32_t salt, uint32_t lo, uint32_t hi) {
  uint32_t h = kGolden ^ salt;
  h = mix_word(h, lo, 0u);
  return mix_word(h, hi, 1u);
}

// hashing.hash_words of two words: fmix32 of the element prefix.
__device__ __forceinline__ uint32_t hash2(uint32_t salt, uint32_t lo, uint32_t hi) {
  return fmix32(element_prefix(salt, lo, hi));
}

// hashing.hash_mod: floor(h * m / 2^32), the high word of the product.
__device__ __forceinline__ uint32_t hash_mod(uint32_t h, uint32_t m) {
  return __umulhi(h, m);
}

// -ln u for register j of an element whose prefix is h
// (hashing.neg_log_uniform of the words (lo, hi, j)).
__device__ __forceinline__ float neg_log_u(uint32_t h, uint32_t j) {
  const uint32_t bits = fmix32(mix_word(h, j, 2u));
  const float u = (float)(bits >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
  return -logf(u);
}

// The unclipped y = floor(log2 w - log2(-ln u)); NaN or +-inf for a
// degenerate weight (and +inf where u rounds to 1.0).
__device__ __forceinline__ float raw_y(uint32_t h, float log2w, uint32_t j) {
  return floorf(log2w - log2f(neg_log_u(h, j)));
}

// y = clip(raw_y, r_min, r_max); a NaN y clips to r_min.
__device__ __forceinline__ float quantized_y(uint32_t h, float log2w, uint32_t j,
                                             float lo_clip, float hi_clip) {
  return fminf(fmaxf(raw_y(h, log2w, j), lo_clip), hi_clip);
}

}  // namespace qsketch_y

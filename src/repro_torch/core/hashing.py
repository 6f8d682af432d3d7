"""Portable, deterministic, counter-based hashing for sketch updates.

The same murmur3-style family as the JAX package (``repro/core/hashing.py``),
word for word: element x hashes to the same h_j(x) in both packages, which
is what lets a state cross between them (``repro_torch/convert.py``) and
lets the parity tests compare bits.

Representation: PyTorch on the CPU has no uint32 ``<<``, ``>>``, ``+`` or
``<``, so a uint32 word is held in an int64 tensor with a value in
[0, 2^32). Every product of two such words is taken modulo 2^64 by the
int64 multiply (two's-complement wraparound) and masked back to 32 bits,
which keeps its low 32 bits exact. The CUDA kernels (``csrc/``) run the
same rounds in native ``uint32_t``.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# murmur3 constants.
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9

# 2^-24 and 2^-25 as float32-exact python floats.
_INV_2_24 = float(2.0**-24)
_HALF_ULP = float(2.0**-25)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's low 32 bits as an int64 tensor in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def _mul(x, c: int):
    return (x * (c & MASK32)) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def fmix32(h):
    """murmur3 finalizer: full-avalanche 32-bit mix."""
    h = h ^ (h >> 16)
    h = _mul(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul(h, _FMIX2)
    h = h ^ (h >> 16)
    return h


def hash_words(words, salt: int):
    """Mix a sequence of uint32 words (broadcastable int64 tensors in
    [0, 2^32)) into uint32 bits, held as int64.

    ``hash_words((lo[:, None], hi[:, None], j[None, :]), salt)`` produces
    the full (B, m) table in one vectorized call.
    """
    h = (_GOLDEN ^ (salt & MASK32)) & MASK32
    for i, w in enumerate(words):
        k = _mul(w, _C1)
        k = _rotl(k, 15)
        k = _mul(k, _C2)
        h = h ^ k
        h = _rotl(h, 13)
        h = (h * 5 + ((0xE6546B64 + 0x9E3779B1 * i) & MASK32)) & MASK32
    return fmix32(h)


def bits_to_unit_open(bits):
    """uint32 bits -> float32 from the top 24 bits plus half an ulp.

    The JAX package's map, kept bit for bit. Note that it reaches 1.0
    (not 1 - 2^-25) when the top 24 bits are all ones: (2^25 - 1)·2^-25
    rounds to even in float32.
    """
    return (bits >> 8).to(torch.float32) * _INV_2_24 + _HALF_ULP


def uniform01(words, salt: int):
    """Uniform (0,1] float32 from integer words: u = h(words) mapped by
    ``bits_to_unit_open``."""
    return bits_to_unit_open(hash_words(words, salt))


def neg_log_uniform(words, salt: int):
    """-ln(U) with U ~ Uniform(0,1): a standard Exp(1) variable."""
    return -torch.log(uniform01(words, salt))


def hash_mod(words, salt: int, m: int):
    """Map words uniformly onto {0, ..., m-1}: floor(h * m / 2^32).

    One int64 product is exact here (h < 2^32 and m < 2^31, so h·m < 2^63);
    the JAX package computes the same value in 16-bit limbs. Returns int64.
    """
    if not 0 < m < 2**31:
        raise ValueError(f"hash_mod needs 0 < m < 2^31, got {m}")
    return (hash_words(words, salt) * m) >> 32


def split_id64(ids):
    """Normalize element ids to a (lo, hi) pair of int64 tensors in [0, 2^32).

    Accepts a (lo, hi) tuple, an int64 tensor (a 64-bit id: lo and hi are
    its two words, so a uint64 id above 2^63 arrives two's-complement), or
    a narrower integer tensor (a 32-bit id: hi = 0, as in the JAX package).
    """
    if isinstance(ids, tuple):
        lo, hi = ids
        return as_u32(lo), as_u32(hi)
    if ids.dtype == torch.int64:
        return ids & MASK32, (ids >> 32) & MASK32
    return as_u32(ids), torch.zeros(ids.shape, dtype=torch.int64, device=ids.device)

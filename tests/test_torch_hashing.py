"""Parity of the port's hashing and quantization with the JAX package.

Integer stages bit for bit on 2^16 words (0, 2^32-1 and 64-bit ids
included); the quantized values y bit for bit as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SketchConfig as JCfg
from repro.core import hashing as jh
from repro.core import key_directory as jkd
from repro.core import qsketch as jq
from repro.core import qsketch_dyn as jqd
from repro_torch.core import SketchConfig
from repro_torch.core import hashing, key_directory, qsketch, qsketch_dyn

N = 1 << 16


def _words(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, N, dtype=np.uint32)
    b = rng.integers(0, 2**32, N, dtype=np.uint32)
    a[:4] = [0, 2**32 - 1, 0, 2**32 - 1]
    b[:4] = [0, 0, 2**32 - 1, 2**32 - 1]
    return a, b


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_hash_words_bit_for_bit(n_words):
    a, b = _words(n_words)
    c = np.arange(N, dtype=np.uint32) * np.uint32(2654435761)
    words = (a, b, c)[:n_words]
    ref = np.asarray(jh.hash_words(tuple(jnp.asarray(w) for w in words), 0xDEADBEEF))
    out = hashing.hash_words(tuple(_t(w) for w in words), 0xDEADBEEF).numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int64))


@pytest.mark.parametrize("m", [3, 256, 1000, 2**16 + 1, 3_000_017, 2**31 - 1])
def test_hash_mod_bit_for_bit(m):
    a, b = _words(m % 97)
    ref = np.asarray(jh.hash_mod((jnp.asarray(a), jnp.asarray(b)), 0x1234, m))
    out = hashing.hash_mod((_t(a), _t(b)), 0x1234, m).numpy()
    np.testing.assert_array_equal(out, ref.astype(np.int64))
    assert out.min() >= 0 and out.max() < m


def test_split_id64_and_uniforms():
    rng = np.random.default_rng(5)
    ids64 = rng.integers(0, 2**64, N, dtype=np.uint64)
    ids64[:3] = [0, 2**32 - 1, 2**64 - 1]
    lo_j, hi_j = jkd.split_uint64(ids64)
    lo_t, hi_t = key_directory.split_uint64(ids64, device="cpu")
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j).astype(np.int64))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j).astype(np.int64))
    # A single int64 tensor carries the same two words (two's complement).
    lo2, hi2 = hashing.split_id64(torch.from_numpy(ids64.view(np.int64)))
    np.testing.assert_array_equal(lo2.numpy(), lo_t.numpy())
    np.testing.assert_array_equal(hi2.numpy(), hi_t.numpy())
    # 32-bit ids: hi = 0, as in the JAX package.
    ids32 = rng.integers(0, 2**32, N, dtype=np.uint32)
    lo_j, hi_j = jh.split_id64(jnp.asarray(ids32))
    lo3, hi3 = hashing.split_id64(torch.from_numpy(ids32.view(np.int32)))
    np.testing.assert_array_equal(lo3.numpy(), np.asarray(lo_j).astype(np.int64))
    np.testing.assert_array_equal(hi3.numpy(), np.asarray(hi_j).astype(np.int64))
    # The uniform map is exact integer-to-float arithmetic: bit for bit.
    bits = np.asarray(jh.hash_words((lo_j, hi_j), 7))
    u_j = np.asarray(jh.bits_to_unit_open(jnp.asarray(bits)))
    u_t = hashing.bits_to_unit_open(_t(bits)).numpy()
    np.testing.assert_array_equal(u_t, u_j)


def test_choose_and_quantize_bit_for_bit():
    """(j, y) of QSketch-Dyn: j exact; y bit for bit on 2^16 elements."""
    cfg_j, cfg = JCfg(m=256, b=8, seed=11), SketchConfig(m=256, b=8, seed=11)
    a, b = _words(3)
    rng = np.random.default_rng(4)
    w = (rng.gamma(1.0, 2.0, N) + 1e-4).astype(np.float32)
    w[:3] = [1e-30, 1e30, 0.0]
    j_j, y_j = jqd._choose_and_quantize(cfg_j, jnp.asarray(a), jnp.asarray(b), jnp.asarray(w))
    j_t, y_t = qsketch_dyn._choose_and_quantize(cfg, _t(a), _t(b), torch.from_numpy(w))
    np.testing.assert_array_equal(j_t.numpy(), np.asarray(j_j).astype(np.int64))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))


@pytest.mark.parametrize("b", [4, 8])
def test_quantized_values_bit_for_bit(b):
    cfg_j, cfg = JCfg(m=256, b=b, seed=3), SketchConfig(m=256, b=b, seed=3)
    rng = np.random.default_rng(b)
    ids = rng.integers(0, 2**32, 512, dtype=np.uint32)
    w = (rng.gamma(1.0, 2.0, 512) * 10.0 ** rng.integers(-6, 7, 512)).astype(np.float32)
    y_j = np.asarray(jq.quantized_values(cfg_j, jnp.asarray(ids), jnp.asarray(w)))
    y_t = qsketch.quantized_values(cfg, torch.from_numpy(ids.view(np.int32)), torch.from_numpy(w))
    np.testing.assert_array_equal(y_t.numpy(), y_j)

"""The port's XXH64, unsigned remainder and window hash against the JAX
package's (``kmtricks_tpu.ops.xxh64``, JAX on the CPU) and its numpy
golden (``kmtricks_tpu.core.hashers``), exactly, on seeded 64-bit values
with the top bit set and windows up to just under 2^62."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmtricks_tpu.core import hashers as jax_hashers
from kmtricks_tpu.ops import u64 as jax_u64
from kmtricks_tpu.ops import xxh64 as jax_xxh64
from kmtricks_tpu_torch.core import hashers
from kmtricks_tpu_torch.ops import u64
from kmtricks_tpu_torch.ops.xxh64 import window_hash, xxh64

torch.set_num_threads(2)

WINDOWS = [64, 250_048, 2**31 + 64, 2**40, 2**62 - 64]


def u64_values(seed, n=20_000):
    """Uniform u64 values (half with the top bit set) and the edges."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1],
                     dtype=np.uint64)
    return np.concatenate([edges, rng.integers(0, 2**64, n,
                                               dtype=np.uint64)])


def as_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def as_u64(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("w", WINDOWS + [1, 2, 2**62 + 3, 2**63 - 1])
def test_mod_const_matches_numpy_uint64(w):
    x = u64_values(w % 1000)
    assert (x >> np.uint64(63)).sum() > len(x) // 3
    np.testing.assert_array_equal(as_u64(u64.mod_const(as_torch(x), w)),
                                  x % np.uint64(w))


def test_rotl_and_mul_const_wrap_like_uint64():
    x = u64_values(1)
    c = 0x9E3779B185EBCA87
    with np.errstate(over="ignore"):
        exp_mul = x * np.uint64(c)
    np.testing.assert_array_equal(as_u64(u64.mul_const(as_torch(x), c)),
                                  exp_mul)
    for r in (1, 27, 31, 63):
        exp = (x << np.uint64(r)) | (x >> np.uint64(64 - r))
        np.testing.assert_array_equal(as_u64(u64.rotl(as_torch(x), r)), exp)


def _jax_pairs(words):
    """(N, S) u64 -> the JAX package's list of (hi, lo) u32 pairs."""
    return [jax_u64.from_u64_np(words[:, i]) for i in range(words.shape[1])]


@pytest.mark.parametrize("s", [1, 2, 4, 5, 8])
def test_xxh64_matches_jax_and_golden(s):
    words = np.stack([u64_values(10 + s + i, 5000) for i in range(s)], 1)
    got = as_u64(xxh64([as_torch(words[:, i]) for i in range(s)]))
    np.testing.assert_array_equal(got, jax_hashers.xxh64_words(words))
    hi, lo = jax_xxh64.xxh64([tuple(map(jnp.asarray, p))
                              for p in _jax_pairs(words)])
    np.testing.assert_array_equal(
        got, jax_u64.to_u64_np(np.asarray(hi), np.asarray(lo)))


@pytest.mark.parametrize("w", WINDOWS)
def test_window_hash_matches_jax_and_golden(w):
    """Canonical-k-mer-like keys (k = 31, and k = 32 with bit 63 set) and
    partitions with window * partition below 2^63."""
    rng = np.random.default_rng(w % 997)
    keys = u64_values(w % 991)
    keys[: len(keys) // 2] &= np.uint64((1 << 62) - 1)
    nparts = max(1, min(64, (2**63 - 1) // w))
    parts = rng.integers(0, nparts, len(keys)).astype(np.int32)
    got = as_u64(window_hash(as_torch(keys), torch.from_numpy(parts), w))
    golden = jax_hashers.window_hash(keys[:, None], parts, w)
    np.testing.assert_array_equal(got, golden)
    np.testing.assert_array_equal(
        hashers.window_hash(keys[:, None], parts, w), golden)
    hi, lo = jax_xxh64.window_hash(
        [tuple(map(jnp.asarray, jax_u64.from_u64_np(keys)))],
        jnp.asarray(parts), w)
    np.testing.assert_array_equal(
        got, jax_u64.to_u64_np(np.asarray(hi), np.asarray(lo)))
    h = jax_hashers.xxh64_words(keys[:, None])
    assert (h >> np.uint64(63)).sum() > len(keys) // 3


@pytest.mark.parametrize("slots", [2, 3, 4])
def test_window_hash_wide_matches_golden(slots):
    """Wide k-mers (k > 32) hash their span storage: ``slots`` int64 words,
    least significant first, as the numpy golden's (N, slots) rows and the
    JAX package's u64 word list."""
    w = 250_048
    words = np.stack([u64_values(40 + slots + i, 3000)
                      for i in range(slots)], 1)
    parts = np.random.default_rng(slots).integers(0, 4, len(words)).astype(
        np.int32)
    got = as_u64(window_hash([as_torch(words[:, i]) for i in range(slots)],
                             torch.from_numpy(parts), w))
    golden = jax_hashers.window_hash(words, parts, w)
    np.testing.assert_array_equal(got, golden)
    hi, lo = jax_xxh64.window_hash(
        [tuple(map(jnp.asarray, p)) for p in _jax_pairs(words)],
        jnp.asarray(parts), w)
    np.testing.assert_array_equal(
        got, jax_u64.to_u64_np(np.asarray(hi), np.asarray(lo)))

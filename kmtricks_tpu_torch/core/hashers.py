"""Bit-exact hashing: vectorized XXH64 over packed k-mers, hash windows.

Copy of ``kmtricks_tpu/core/hashers.py``, keeping what the port reaches.

The counting hash of the reference (gatb/sorting_count.hpp:347-363) is::

    XXH64(kmer_words, 8 * ceil(k/32), seed=0) % window_bits + window_bits * p

where the k-mer words are hashed as little-endian bytes. We reproduce it
exactly with numpy uint64 arithmetic (wrapping overflow), vectorized over
arrays of k-mers — this is also the golden model for the Pallas kernel.

HashWindow (include/kmtricks/hash.hpp:27-98) splits a Bloom filter of the
requested size into per-partition windows of ``ROUND_UP(ceil(size/parts), 64)``
bits; ``hash.info`` serialization layout is reproduced byte-for-byte.
"""

from __future__ import annotations

import struct

import numpy as np

from kmtricks_tpu_torch.constants import (
    XXH_PRIME64_1 as P1,
    XXH_PRIME64_2 as P2,
    XXH_PRIME64_3 as P3,
    XXH_PRIME64_4 as P4,
    XXH_PRIME64_5 as P5,
)

_U64 = np.uint64


def _u(x: int) -> np.uint64:
    return np.uint64(x & 0xFFFFFFFFFFFFFFFF)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _u(r)) | (x >> _u(64 - r))


def _round(acc, inp):
    acc = acc + inp * _u(P2)
    acc = _rotl(acc, 31)
    return acc * _u(P1)


def _merge_round(h, v):
    h = h ^ _round(np.zeros_like(v), v)
    return h * _u(P1) + _u(P4)


def _avalanche(h):
    h = h ^ (h >> _u(33))
    h = h * _u(P2)
    h = h ^ (h >> _u(29))
    h = h * _u(P3)
    h = h ^ (h >> _u(32))
    return h


def xxh64_words(words: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH64 of (N, S) uint64 word rows, hashed as 8*S little-endian bytes.

    Bit-exact with XXH64(ptr, 8*S, seed) for S in 1..8. Vectorized over rows.
    """
    old = np.seterr(over="ignore")
    try:
        words = np.atleast_2d(np.asarray(words, dtype=np.uint64))
        n, s = words.shape
        total_len = 8 * s
        seed = _u(seed)

        i = 0
        if total_len >= 32:
            v1 = np.full(n, seed + _u(P1) + _u(P2), dtype=_U64)
            v2 = np.full(n, seed + _u(P2), dtype=_U64)
            v3 = np.full(n, seed, dtype=_U64)
            v4 = np.full(n, seed - _u(P1), dtype=_U64)
            while i + 4 <= s:
                v1 = _round(v1, words[:, i])
                v2 = _round(v2, words[:, i + 1])
                v3 = _round(v3, words[:, i + 2])
                v4 = _round(v4, words[:, i + 3])
                i += 4
            h = _rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
            h = _merge_round(h, v1)
            h = _merge_round(h, v2)
            h = _merge_round(h, v3)
            h = _merge_round(h, v4)
        else:
            h = np.full(n, seed + _u(P5), dtype=_U64)

        h = h + _u(total_len)

        while i < s:  # remaining 8-byte lanes
            h = h ^ _round(np.zeros(n, dtype=_U64), words[:, i])
            h = _rotl(h, 27) * _u(P1) + _u(P4)
            i += 1

        return _avalanche(h)
    finally:
        np.seterr(**old)


def xxh64_u32(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH64 over single uint32 values (4 little-endian bytes) — used by the
    static repartition ``XXH64(&m, 4, 0) % nb_parts`` (repartition.hpp:45-56).
    """
    old = np.seterr(over="ignore")
    try:
        v = np.asarray(values, dtype=np.uint32).astype(np.uint64)
        n = v.shape[0] if v.ndim else 1
        h = np.full(n, _u(seed) + _u(P5) + _u(4), dtype=_U64)
        h = h ^ (v * _u(P1))
        h = _rotl(h, 23) * _u(P2) + _u(P3)
        return _avalanche(h)
    finally:
        np.seterr(**old)


# ---------------------------------------------------------------------------
# Hash windows
# ---------------------------------------------------------------------------

def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def nbytes(bits: int) -> int:
    return (bits + 7) // 8


class HashWindow:
    """Bloom-filter partition window math + hash.info (de)serialization.

    Reference: include/kmtricks/hash.hpp:27-98. File layout (little-endian):
    u64 bloom_size, u64 nb_partitions, u64 window_size_bits,
    u64 window_size_bytes, u32 minim_size.
    """

    def __init__(self, bloom_size: int, nb_partitions: int, minim_size: int):
        self.nb_partitions = nb_partitions
        self.minim_size = minim_size
        import math
        self.window_size_bits = round_up(math.ceil(bloom_size / nb_partitions), 64)
        self.window_size_bytes = nbytes(self.window_size_bits)
        self.bloom_size = self.window_size_bits * nb_partitions

    @classmethod
    def load(cls, path: str) -> "HashWindow":
        with open(path, "rb") as f:
            bloom, parts, wbits, wbytes, msize = struct.unpack("<QQQQI", f.read(36))
        obj = cls.__new__(cls)
        obj.bloom_size = bloom
        obj.nb_partitions = parts
        obj.window_size_bits = wbits
        obj.window_size_bytes = wbytes
        obj.minim_size = msize
        return obj

    def serialize(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(struct.pack("<QQQQI", self.bloom_size, self.nb_partitions,
                                self.window_size_bits, self.window_size_bytes,
                                self.minim_size))

    def lower(self, partition: int) -> int:
        return partition * self.window_size_bits

    def upper(self, partition: int) -> int:
        return (partition + 1) * self.window_size_bits - 1


def window_hash(words: np.ndarray, partitions: np.ndarray,
                window_bits: int) -> np.ndarray:
    """The counting hash: XXH64(kmer) % window + window * partition."""
    h = xxh64_words(words)
    return h % _u(window_bits) + _u(window_bits) * partitions.astype(np.uint64)


def bloom_fp(m: int, n: int, k: int = 1) -> float:
    """Bloom filter false-positive rate (utils.hpp:239-243)."""
    import math
    return (1.0 - math.e ** (-(k * float(n)) / float(m))) ** k

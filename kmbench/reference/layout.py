"""Frozen copies of the kmtricks conventions the reference needs: the
2-bit code, the minimizer order, the partition-count rule, XXH64's
constants and the byte layouts of the files a run writes.

These are written out here from the kmtricks file and algorithm
descriptions (kmtricks ``include/kmtricks/{kmer,repartition,hash,
io/*}.hpp``, GATB ``Model.hpp`` and ``ConfigurationAlgorithm.cpp``, the
HowDe-SBT ``bloom_filter_file.h`` layout), so that a change to the
program under test cannot move them.
"""

from __future__ import annotations

import struct

import numpy as np

# kmtricks' 2-bit code: A=0, C=1, T=2, G=3; the complement is code ^ 2.
CODE = np.full(256, -1, dtype=np.int8)
for _ch, _v in zip(b"ACTG", range(4)):
    CODE[_ch] = _v
    CODE[ord(chr(_ch).lower())] = _v

# file magics and version
MAGIC_BASE = 0x736B636972746D6B          # "kmtricks"
IO_VERSION = 0
MAGIC_MATRIX_K = 0x6B5F78697274616D      # "matrix_k"
MAGIC_BITMATRIX = 0x74616D746962         # "bitmat"
MAGIC_REPART = 0x12345678

# HowDe-SBT bloom filter file (one uncompressed simple vector)
BF_MAGIC = 0xD0B10F21D0B10F21
BF_VERSION = 2
BF_KIND_SIMPLE = 1
BV_UNCOMPRESSED = 0
_BF_HEADER = struct.Struct("<QIII4xIIQQQQI?3xQ")
_BF_VECTOR = struct.Struct("<IIQQQ")

# XXH64 primes
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


def _base_header(magic: int) -> bytes:
    return struct.pack("<QI?Q", MAGIC_BASE, IO_VERSION, False, magic)


def matrix_header(k: int, nsamp: int, partition: int) -> bytes:
    """Header of ``matrices/matrix_<p>.count``: kmer size, key words, a
    count-slots field of 1 (kmtricks writes 1 whatever the count width),
    samples, sample id 0, partition. Records follow: the key as u64
    words, then one u32 count per sample."""
    return _base_header(MAGIC_MATRIX_K) + struct.pack(
        "<IIIIII", k, (k + 31) // 32, 1, nsamp, 0, partition)


def bitmatrix_header(nsamp: int, partition: int, first: int,
                     window: int) -> bytes:
    """Header of ``matrices/matrix_<p>.cmbf`` (bft): row width in bits,
    the window's first hash, its size, sample id 0, partition."""
    return _base_header(MAGIC_BITMATRIX) + struct.pack(
        "<IQQII", nsamp, first, window, 0, partition)


def repart_bytes(table: np.ndarray, nb_partitions: int) -> tuple[bytes,
                                                                 bytes]:
    """``repartition/repartition.minimRepart`` split into its header
    (u16 partitions, u64 minimizers, u16 passes) and trailer (u8 has
    frequencies, u32 magic); the u16 table lies between."""
    return (struct.pack("<HQH", nb_partitions, len(table), 1),
            struct.pack("<?I", False, MAGIC_REPART))


def bf_header(bloom_bits: int, k: int) -> bytes:
    """Header of ``filters/<sample>.bf``, padded to 16 bytes; then u64
    bits and the bits as little-endian u64 words."""
    size = (_BF_HEADER.size + _BF_VECTOR.size + 15) & ~15
    out = _BF_HEADER.pack(BF_MAGIC, size, BF_VERSION, BF_KIND_SIMPLE, k, 1,
                          0, 0, bloom_bits, bloom_bits, 1, False, 0)
    out += _BF_VECTOR.pack(BV_UNCOMPRESSED, 0, size, bloom_bits // 8 + 8, 0)
    return out + b"\x00" * (size - len(out))


def window_bits(bloom_size: int, nb_partitions: int) -> int:
    """Bits of one partition's Bloom window: ceil(bloom / P) rounded up to
    a multiple of 64."""
    w = -(-bloom_size // nb_partitions)
    return -(-w // 64) * 64


def nb_partitions(kmers: int, k: int, max_memory_mb: int) -> int:
    """kmtricks' automatic partition count for one pass and one core:
    a volume of ``kmers`` keys of 2 * span bits (span 32 for k < 32),
    60% of it over the memory, plus one, and never under 4."""
    span = next(s for s in (32, 64, 96, 128) if k < s)
    volume = max(1, kmers * (span // 4) // (1 << 20))
    return max(4, int(volume * 0.6) // max(1, max_memory_mb) + 1)


def masked_minimizer_lut(m: int) -> np.ndarray:
    """For every forward m-mer value: its canonical value (the smaller of
    the m-mer and its reverse complement), or 4^m - 1 where that value
    holds 'AA' at any position but the first (such m-mers are never
    minimizers). The minimizer of a k-mer is the least of these over its
    k - m + 1 m-mers."""
    n = 4 ** m
    v = np.arange(n, dtype=np.int64)
    digits = [(v >> (2 * (m - 1 - i))) & 3 for i in range(m)]   # first base
    rc = np.zeros(n, dtype=np.int64)
    for i in range(m):             # base i of the m-mer is base m-1-i of rc
        rc |= (digits[i] ^ 2) << (2 * i)
    cano = np.minimum(v, rc)
    cd = [(cano >> (2 * (m - 1 - i))) & 3 for i in range(m)]
    forbidden = np.zeros(n, dtype=bool)
    for i in range(1, m - 1):
        forbidden |= (cd[i] == 0) & (cd[i + 1] == 0)
    return np.where(forbidden, n - 1, cano)

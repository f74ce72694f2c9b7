"""XXH64 and the counting window hash on int64 tensors.

Counterpart of ``kmtricks_tpu/ops/xxh64.py`` (``xxh64``, ``xxh64_u32``,
``static_partitions``, ``window_hash``): a bit-exact XXH64(words, 8 * S,
seed) over S 64-bit words, the reference counting hash
(gatb/sorting_count.hpp:347-363), and the 4-byte XXH64 of the static
repartition, with each u64 held in one int64 tensor
(:mod:`kmtricks_tpu_torch.ops.u64`) instead of a (hi, lo) u32 pair. Plain
elementwise torch, as the JAX version is plain XLA.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.constants import (
    XXH_PRIME64_1 as P1,
    XXH_PRIME64_2 as P2,
    XXH_PRIME64_3 as P3,
    XXH_PRIME64_4 as P4,
    XXH_PRIME64_5 as P5,
)
from kmtricks_tpu_torch.ops.u64 import mod_const, mul_const, rotl, s64, shr


def _round(acc, inp):
    return mul_const(rotl(acc + mul_const(inp, P2), 31), P1)


def _merge_round(h, v):
    h = h ^ _round(torch.zeros_like(v), v)
    return mul_const(h, P1) + s64(P4)


def _avalanche(h):
    h = mul_const(h ^ shr(h, 33), P2)
    h = mul_const(h ^ shr(h, 29), P3)
    return h ^ shr(h, 32)


def xxh64(words, seed: int = 0) -> torch.Tensor:
    """XXH64 over S 64-bit words per element: ``words`` is a sequence of
    S int64 tensors of one shape (word i is bytes 8i..8i+7 of the input,
    little-endian), or one tensor (S = 1, a k-mer of k <= 32). Returns the
    hash's u64 bits as int64."""
    if isinstance(words, torch.Tensor):
        words = (words,)
    s = len(words)
    total_len = 8 * s
    i = 0
    if total_len >= 32:
        def start(c):
            return torch.full_like(words[0], s64(c))

        v = [start(seed + P1 + P2), start(seed + P2), start(seed),
             start(seed - P1)]
        while i + 4 <= s:
            v = [_round(v[j], words[i + j]) for j in range(4)]
            i += 4
        h = (rotl(v[0], 1) + rotl(v[1], 7)) + (rotl(v[2], 12)
                                              + rotl(v[3], 18))
        for vj in v:
            h = _merge_round(h, vj)
        h = h + total_len
    else:
        h = torch.full_like(words[0], s64(seed + P5 + total_len))
    while i < s:
        h = h ^ _round(torch.zeros_like(h), words[i])
        h = mul_const(rotl(h, 27), P1) + s64(P4)
        i += 1
    return _avalanche(h)


def xxh64_u32(values: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """XXH64 of one little-endian u32 (a 4-byte input) per element, the
    static repartition hash (repartition.hpp:45-56); ``values`` hold the
    u32 in their low 32 bits. Returns the hash's u64 bits as int64."""
    h = torch.full(values.shape, s64(seed + P5 + 4), dtype=torch.int64,
                   device=values.device)
    h = h ^ mul_const(values.to(torch.int64) & 0xFFFFFFFF, P1)
    h = mul_const(rotl(h, 23), P2) + s64(P3)
    return _avalanche(h)


def static_partitions(minim: torch.Tensor, nb_parts: int) -> torch.Tensor:
    """``--static-repart``: partition = XXH64(minimizer u32) % nb_parts,
    computed instead of gathered; equal to ``Repartition.from_xxh``'s
    table for every minimizer. int32 out."""
    return mod_const(xxh64_u32(minim), nb_parts).to(torch.int32)


def window_hash(keys, parts: torch.Tensor,
                window_bits: int) -> torch.Tensor:
    """The counting hash: XXH64(kmer) % window + window * partition, for
    canonical k-mers (one int64 tensor for k <= 32, or the span's words
    least significant first, which XXH64 reads as the k-mer's little-endian
    storage) and their partitions; int64 out. ``window_bits`` (the window
    size in bits) times the partition count stays below 2^63 (HashWindow
    bounds the Bloom size)."""
    return mod_const(xxh64(keys), window_bits) + \
        parts.to(torch.int64) * window_bits

"""64-bit key helpers on int64 tensors.

The JAX package emulates u64 with (hi, lo) u32 pairs (the TPU has no
64-bit integer path). Here a u64 bit pattern lives in one int64 tensor,
which needs three corrections against PyTorch's signed semantics:

* ``int64 >>`` is arithmetic, so a logical shift masks the sign copies off
  (:func:`shr`); ``uint64 >>`` is not implemented at all;
* ``torch.sort`` and comparisons are signed, so unsigned order flips
  bit 63 first (:func:`flip`);
* ``int64 <<``, ``+`` and ``*`` wrap mod 2^64, as u64 does;
* ``%`` and ``//`` are signed and floor-based, so the unsigned remainder
  (:func:`mod_const`) works on the low 63 bits and adds bit 63 back.

Wide k-mers (k > 32) are lists of such words, least significant first
(:func:`shr_words`, :func:`lt_words`).
"""

from __future__ import annotations

import torch

SIGN = -(1 << 63)          # bit 63 as an int64 value
INT64_MAX = (1 << 63) - 1


def s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >> 63 else c


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a constant 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def flip(x: torch.Tensor) -> torch.Tensor:
    """Map u64 order onto int64 order (an involution)."""
    return x ^ SIGN


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned ``a < b`` of int64 bit patterns."""
    return flip(a) < flip(b)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned minimum of int64 bit patterns."""
    return torch.where(ult(a, b), a, b)


# Multi-word integers: lists of int64 words, least significant first (the
# (N, slots) little-endian u64 rows of the host k-mer layout)

def shr_words(words, s: int):
    """Logical right shift of a multi-word integer by a constant s >= 0
    (counterpart of ``kmtricks_tpu/ops/encode.py::_shr_words``)."""
    nw = len(words)
    q, r = divmod(s, 64)
    out = []
    for i in range(nw):
        if i + q >= nw:
            out.append(torch.zeros_like(words[0]))
            continue
        v = shr(words[i + q], r)
        if r and i + q + 1 < nw:
            v = v | (words[i + q + 1] << (64 - r))
        out.append(v)
    return out


def lt_words(a, b) -> torch.Tensor:
    """Unsigned lexicographic ``a < b`` of two multi-word integers (a
    per-word ``umin`` is not lexicographic; bit 63 is set in half of all
    keys)."""
    lt = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):        # least significant first: later words win
        lt = torch.where(x != y, ult(x, y), lt)
    return lt


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64 bit patterns left by a constant 0 < r < 64."""
    return (x << r) | shr(x, 64 - r)


def mul_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` mod 2^64 for an unsigned 64-bit constant ``c``."""
    return x * s64(c)


def mod_const(x: torch.Tensor, w: int) -> torch.Tensor:
    """Unsigned ``x % w`` of int64 bit patterns for a constant
    1 <= w < 2^63 (counterpart of the JAX package's Barrett ``mod_const``).

    The low 63 bits are non-negative, so the signed ``%`` is exact on
    them; bit 63 adds ``2^63 % w``, folded back by a compare and subtract
    (``a + b`` may pass 2^63 when w > 2^62)."""
    if not 1 <= w <= INT64_MAX:
        raise ValueError(f"mod_const: modulus {w} out of [1, 2^63)")
    a = (x & INT64_MAX) % w
    b = torch.where(x < 0, (1 << 63) % w, 0)
    return torch.where(a >= w - b, a - (w - b), a + b)

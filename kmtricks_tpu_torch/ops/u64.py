"""64-bit key helpers on int64 tensors.

The JAX package emulates u64 with (hi, lo) u32 pairs (the TPU has no
64-bit integer path). Here a u64 bit pattern lives in one int64 tensor,
which needs three corrections against PyTorch's signed semantics:

* ``int64 >>`` is arithmetic, so a logical shift masks the sign copies off
  (:func:`shr`); ``uint64 >>`` is not implemented at all;
* ``torch.sort`` and comparisons are signed, so unsigned order flips
  bit 63 first (:func:`flip`);
* ``int64 <<`` and ``*`` wrap mod 2^64, as u64 does.
"""

from __future__ import annotations

import torch

SIGN = -(1 << 63)          # bit 63 as an int64 value


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


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned minimum of int64 bit patterns."""
    return torch.where(flip(a) < flip(b), a, b)

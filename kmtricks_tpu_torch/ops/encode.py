"""Encode: ASCII read batches -> canonical k-mers, minimizers, partitions.

Counterpart of ``kmtricks_tpu/ops/encode.py`` for k <= 32, with the same
semantics (byte-identical matrices follow from them):

* codes via ``(ascii >> 1) & 3`` (A=0, C=1, T=2, G=3), valid iff in "ACGTacgt"
* canonical k-mer = unsigned min(fwd, revcomp) of the 2-bit packing, held
  here as ONE int64 key instead of a (hi, lo) u32 pair
* minimizer = min over the window's masked canonical m-mers (sentinel
  4^m - 1 for forbidden "AA-after-front" m-mers)
* partition = repart_table[minimizer]

Batches are (B, L); the JAX package's (L, B) layout is a TPU sublane trick
and has no counterpart here.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.ops.u64 import s64, shr, umin

_AAAA = s64(0xAAAAAAAAAAAAAAAA)
_REV_STEPS = ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
              (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF),
              (32, 0x00000000FFFFFFFF))


def ascii_to_codes(batch: torch.Tensor):
    """(B, L) uint8 ASCII -> (codes int64, valid bool)."""
    codes = ((batch >> 1) & 3).to(torch.int64)
    valid = torch.zeros(batch.shape, dtype=torch.bool, device=batch.device)
    for c in b"ACGTacgt":
        valid |= batch == c
    return codes, valid


def _rev2bit64(x: torch.Tensor) -> torch.Tensor:
    """Reverse the thirty-two 2-bit groups of each int64 bit pattern.

    Every mask has its top ``s`` bits clear, so the arithmetic ``>>``
    needs no extra masking."""
    for s, m in _REV_STEPS:
        x = ((x >> s) & m) | ((x & m) << s)
    return x


def revcomp64(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (k <= 32): reverse the 2-bit
    groups, complement (XOR 0b10 per group), realign right."""
    return shr(_rev2bit64(kmer) ^ _AAAA, 2 * (32 - k))


def canonical64(kmer: torch.Tensor, k: int) -> torch.Tensor:
    return umin(kmer, revcomp64(kmer, k))


def mmer_canonical(v: torch.Tensor, m: int) -> torch.Tensor:
    """Canonical value of non-negative m-mer values (m <= 15)."""
    return torch.minimum(v, shr(_rev2bit64(v) ^ _AAAA, 64 - 2 * m))


def mmer_allowed(v: torch.Tensor, m: int) -> torch.Tensor:
    """GATB is_allowed bit trick on m-mer values."""
    if m < 3:
        return torch.ones_like(v, dtype=torch.bool)
    mask00 = 0x5555555555555555 & ((1 << (2 * m - 4)) - 1)
    a = ~(v | (v >> 2))
    return (((a >> 1) & a) & mask00) == 0


def sliding_min(x: torch.Tensor, w: int) -> torch.Tensor:
    """Windowed min of width ``w`` along dim 1 (prefix doubling, O(log w)
    passes). Output length = n - w + 1."""
    c, y = 1, x
    while c < w:
        s = min(c, w - c)
        n = y.shape[1] - s
        y = torch.minimum(y[:, :n], y[:, s:s + n])
        c += s
    return y


def _window_validity(char_valid: torch.Tensor, lengths: torch.Tensor,
                     k: int) -> torch.Tensor:
    """(B, W) bool: the window has k valid chars and fits the read."""
    bad = torch.cumsum((~char_valid).to(torch.int32), dim=1,
                       dtype=torch.int32)
    csz = torch.nn.functional.pad(bad, (1, 0))
    W = char_valid.shape[1] - k + 1
    clean = (csz[:, k:k + W] - csz[:, :W]) == 0
    pos = torch.arange(W, dtype=torch.int32, device=char_valid.device)
    return clean & (pos[None, :] + k <= lengths[:, None])


def _minimizer_partitions(codes: torch.Tensor, repart_table: torch.Tensor,
                          k: int, m: int,
                          canonical_mmers: bool = True) -> torch.Tensor:
    """Per-window minimizers -> int32 partition ids (table gather)."""
    Wm = codes.shape[1] - m + 1
    mv = codes[:, :Wm].clone()
    for j in range(1, m):
        mv.bitwise_left_shift_(2).bitwise_or_(codes[:, j:j + Wm])
    mc = mmer_canonical(mv, m) if canonical_mmers else mv
    masked = torch.where(mmer_allowed(mc, m), mc, (1 << (2 * m)) - 1)
    minim = sliding_min(masked, k - m + 1)
    return repart_table[minim].to(torch.int32)


def encode_batch(batch: torch.Tensor, lengths: torch.Tensor,
                 repart_table: torch.Tensor, k: int, m: int,
                 mmer_canonical: bool = True):
    """Encode a (B, L) uint8 read batch into routed canonical k-mers.

    ``lengths`` (B,) int32 read lengths; ``repart_table`` (4^m,) int32.
    Returns (keys (B, W) int64 canonical k-mers, parts (B, W) int32,
    valid (B, W) bool), W = L - k + 1.
    """
    if not 0 < k <= 32:
        raise NotImplementedError(f"k = {k}: only k <= 32 is ported")
    codes, char_valid = ascii_to_codes(batch)
    W = batch.shape[1] - k + 1
    valid = _window_validity(char_valid, lengths, k)
    # forward k-mers rolled in over k slices, in place on one buffer
    fwd = codes[:, :W].clone()
    for j in range(1, k):
        fwd.bitwise_left_shift_(2).bitwise_or_(codes[:, j:j + W])
    keys = canonical64(fwd, k)
    parts = _minimizer_partitions(codes, repart_table, k, m, mmer_canonical)
    return keys, parts, valid

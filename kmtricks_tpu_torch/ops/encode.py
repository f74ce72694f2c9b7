"""Encode: ASCII read batches -> canonical k-mers, minimizers, partitions.

Counterpart of ``kmtricks_tpu/ops/encode.py`` (``encode_batch``,
``encode_batch_wide``, ``device_key_words``), with the same semantics
(byte-identical matrices follow from them):

* codes via ``(ascii >> 1) & 3`` (A=0, C=1, T=2, G=3), valid iff in "ACGTacgt"
* canonical k-mer = unsigned min(fwd, revcomp) of the 2-bit packing: ONE
  int64 key for k <= 32 (instead of a (hi, lo) u32 pair), and for
  32 < k <= 128 the reference's span storage (64, 96 or 128 nt) as 2, 3 or
  4 int64 words, least significant first (the host's (N, slots)
  little-endian u64 rows)
* minimizer = min over the window's masked canonical m-mers (sentinel
  4^m - 1 for forbidden "AA-after-front" m-mers)
* partition = repart_table[minimizer], or XXH64(minimizer) % P under
  ``--static-repart`` (``static_parts``)

Batches are (B, L); the JAX package's (L, B) layout is a TPU sublane trick
and has no counterpart here.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.ops.u64 import lt_words, s64, shr, shr_words, umin

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


def _roll_in(codes: torch.Tensor, start: int, n: int, W: int):
    """(B, W) int64: the ``n`` <= 32 codes from ``start`` of each window
    packed most significant first, rolled in over n slices in place on one
    buffer."""
    out = codes[:, start:start + W].clone()
    for j in range(1, n):
        out.bitwise_left_shift_(2).bitwise_or_(codes[:, start + j:
                                                     start + j + W])
    return out


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


def device_key_words(k: int) -> int:
    """The JAX package's msb-first u32 key words of a k-mer: the span is
    the smallest of {32, 64, 96, 128} holding k (loop_executor.hpp:23-70 /
    KMER_LIST), two u32 words per 32-nt span word; the port holds half as
    many int64 words."""
    if not 0 < k <= 128:
        raise NotImplementedError(f"k = {k}: k-mers hold at most 128 nt")
    span = next(s for s in (32, 64, 96, 128) if k <= s)
    return span // 16


def forward_words(codes: torch.Tensor, k: int, W: int, nwords: int):
    """Forward k-mers of the (B, W) windows as ``nwords`` int64 words,
    least significant first: word w holds codes k-32w-32 .. k-1-32w of the
    window, each word rolled in on its own (k shift-or passes in all).
    The span's top word is never empty: k > 32 * (nwords - 1)."""
    words = []
    for w in range(nwords):
        hi = k - 1 - 32 * w
        lo = max(0, hi - 31)
        words.append(_roll_in(codes, lo, hi - lo + 1, W))
    return words


def revcomp_words(fwd, k: int):
    """Reverse complement of the span storage (32 nt per word): reverse
    the 2-bit groups of every word and the word order, complement, then
    realign right by 2 * (span - k) (kmer.hpp rev_comp)."""
    nw = len(fwd)
    rc = [_rev2bit64(fwd[nw - 1 - i]) ^ _AAAA for i in range(nw)]
    return shr_words(rc, 2 * (32 * nw - k))


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


def masked_mmers(codes: torch.Tensor, m: int,
                 canonical_mmers: bool = True) -> torch.Tensor:
    """(B, L - m + 1) int64: each m-mer's value (canonical unless told
    otherwise), forbidden ones replaced by the sentinel 4^m - 1."""
    mv = _roll_in(codes, 0, m, codes.shape[1] - m + 1)
    mc = mmer_canonical(mv, m) if canonical_mmers else mv
    return torch.where(mmer_allowed(mc, m), mc, (1 << (2 * m)) - 1)


def _minimizer_partitions(codes: torch.Tensor, repart_table: torch.Tensor,
                          k: int, m: int, canonical_mmers: bool = True,
                          static_parts: int | None = None) -> torch.Tensor:
    """Per-window minimizers -> int32 partition ids: the table gather, or
    XXH64(minimizer) % ``static_parts`` (--static-repart)."""
    minim = sliding_min(masked_mmers(codes, m, canonical_mmers), k - m + 1)
    if static_parts is not None:
        from kmtricks_tpu_torch.ops.xxh64 import static_partitions
        return static_partitions(minim, static_parts)
    return repart_table[minim].to(torch.int32)


def encode_batch(batch: torch.Tensor, lengths: torch.Tensor,
                 repart_table: torch.Tensor, k: int, m: int,
                 mmer_canonical: bool = True,
                 static_parts: int | None = None):
    """Encode a (B, L) uint8 read batch into routed canonical k-mers
    (k <= 32; :func:`encode_batch_wide` takes larger k).

    ``lengths`` (B,) int32 read lengths; ``repart_table`` (4^m,) int32
    (unused under ``static_parts`` = nb_partitions). Returns (keys (B, W)
    int64 canonical k-mers, parts (B, W) int32, valid (B, W) bool),
    W = L - k + 1.
    """
    if not 0 < k <= 32:
        raise NotImplementedError(f"k = {k}: encode_batch takes k <= 32 "
                                  "(encode_batch_wide the rest)")
    codes, char_valid = ascii_to_codes(batch)
    W = batch.shape[1] - k + 1
    valid = _window_validity(char_valid, lengths, k)
    keys = canonical64(_roll_in(codes, 0, k, W), k)
    parts = _minimizer_partitions(codes, repart_table, k, m, mmer_canonical,
                                  static_parts)
    return keys, parts, valid


def encode_batch_wide(batch: torch.Tensor, lengths: torch.Tensor,
                      repart_table: torch.Tensor, k: int, m: int,
                      mmer_canonical: bool = True,
                      static_parts: int | None = None):
    """Encode for 32 < k <= 128: canonical k-mers as the reference's span
    storage, ``device_key_words(k) // 2`` int64 words (2 for k <= 64, 3
    for k <= 96, 4 for k <= 128), least significant first. Returns (keys
    tuple of (B, W) int64, parts (B, W) int32, valid (B, W) bool), as
    :func:`encode_batch`."""
    if not 32 < k <= 128:
        raise NotImplementedError(f"k = {k}: encode_batch_wide takes "
                                  "32 < k <= 128")
    nwords = device_key_words(k) // 2
    codes, char_valid = ascii_to_codes(batch)
    W = batch.shape[1] - k + 1
    valid = _window_validity(char_valid, lengths, k)
    fwd = forward_words(codes, k, W, nwords)
    rc = revcomp_words(fwd, k)
    take_rc = lt_words(rc, fwd)
    keys = tuple(torch.where(take_rc, r, f) for r, f in zip(rc, fwd))
    del fwd, rc, take_rc
    parts = _minimizer_partitions(codes, repart_table, k, m, mmer_canonical,
                                  static_parts)
    return keys, parts, valid

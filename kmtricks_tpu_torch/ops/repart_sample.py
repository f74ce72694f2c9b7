"""Repartition sampler: the SampleRepart kx-mer tally on the device.

Counterpart of ``kmtricks_tpu/ops/repart_sample.py`` (``_sliding_min_pair``,
``_window_minimizer_values``, ``_strand_forward``, ``tally_step``,
``make_bins``). The reference samples the bank and tallies KX-MER STARTS
per minimizer to weight the LPT bin packing
(RepartitionAlgorithm.cpp:157-243): within each superkmer (maximal run of
consecutive valid k-mer windows sharing a minimizer), a new kx-mer starts
when the canonical strand flips or every 4th k-mer of a same-strand run.

Read blocks arrive as raw ASCII bytes in the reads' own width and are
encoded on their device (``ops/encode.py::ascii_to_codes``); every
per-window quantity (minimizer, strand, run break, kx start) is a (B, W)
tensor pass with its scans along the contiguous dim 1 (a scan down the
rows of a narrow matrix runs one CUDA thread per column); one
``index_add_`` lands the block's tally in a resident (4^m,) int64 table,
so only the final 4^m counters leave the device. Plain torch, as the JAX
version is plain XLA: bit-equal to the host numpy tally
(``runtime/pipeline.py::_tally_kxmer_starts``).
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.ops.encode import (
    _roll_in, _window_validity, ascii_to_codes, device_key_words,
    forward_words, masked_mmers, revcomp64, revcomp_words, sliding_min)
from kmtricks_tpu_torch.ops.u64 import lt_words, ult


def _sliding_min_pair(r: torch.Tensor, v: torch.Tensor, w: int):
    """Windowed lexicographic min of (rank, value) pairs along dim 1 (the
    --minimizer-type 1 comparator, ComparatorMinimizerFrequencyOrLex,
    Model.hpp:911-976), in the prefix-doubling shape of
    :func:`~kmtricks_tpu_torch.ops.encode.sliding_min`."""
    c = 1
    while c < w:
        s = min(c, w - c)
        n = r.shape[1] - s
        ar, av, br, bv = r[:, :n], v[:, :n], r[:, s:s + n], v[:, s:s + n]
        take_b = (br < ar) | ((br == ar) & (bv < av))
        r, v = torch.where(take_b, br, ar), torch.where(take_b, bv, av)
        c += s
    return r, v


def _window_minimizer_values(codes: torch.Tensor, k: int, m: int,
                             freq_table=None) -> torch.Tensor:
    """(B, W) int64 minimizer VALUES (not partitions): min over the
    window's masked canonical m-mers; with a ``freq_table`` (4^m,) of
    sampled frequency ranks, m-mers compare by rank first, value second
    (``core/kmer.py::window_minimizers``)."""
    masked = masked_mmers(codes, m)
    if freq_table is None:
        return sliding_min(masked, k - m + 1)
    return _sliding_min_pair(freq_table[masked], masked, k - m + 1)[1]


def _strand_forward(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(B, W) bool: the canonical strand of each window is the forward
    one (the GATB comparator: NOT revcomp < forward, unsigned; at k = 32
    the keys use bit 63)."""
    W = codes.shape[1] - k + 1
    if k <= 32:
        fwd = _roll_in(codes, 0, k, W)
        return ~ult(revcomp64(fwd, k), fwd)
    fwd = forward_words(codes, k, W, device_key_words(k) // 2)
    return ~lt_words(revcomp_words(fwd, k), fwd)


def _after_first(x: torch.Tensor) -> torch.Tensor:
    """(B, W - 1) comparisons of window i with i - 1 -> (B, W), False at
    each read's first window."""
    return torch.nn.functional.pad(x, (1, 0))


def tally_step(bins: torch.Tensor, block: torch.Tensor,
               lengths: torch.Tensor, *, k: int, m: int,
               freq_table=None) -> torch.Tensor:
    """Add one read block's kx-mer-start tally to ``bins`` in place.

    bins (4^m,) int64 on the block's device; block (B, L) uint8 ASCII
    rows, any L (bytes past a row's length are ignored); lengths (B,)
    int32 (padding rows 0); freq_table (4^m,) int64 ranks under
    --minimizer-type 1, else None. Returns ``bins``."""
    if block.shape[1] < k:      # no row holds a window
        return bins
    codes, char_valid = ascii_to_codes(block)
    wv = _window_validity(char_valid, lengths, k)                  # (B, W)
    del char_valid
    minim = _window_minimizer_values(codes, k, m, freq_table)
    which = _strand_forward(codes, k)
    del codes
    # run breaks within each read (a read's first window always breaks,
    # as the host tally's 'N' separator makes it)
    same_min = _after_first((minim[:, 1:] == minim[:, :-1])
                            & wv[:, 1:] & wv[:, :-1])
    same_strand = _after_first(which[:, 1:] == which[:, :-1])
    del which
    wb = ~same_min | ~same_strand
    idx = torch.arange(wv.shape[1], device=wv.device)
    run_start = torch.cummax(torch.where(wb, idx, 0), dim=1).values
    kx_start = (wb | (((idx - run_start) & 3) == 0)) & wv
    return bins.index_add_(0, minim.reshape(-1),
                           kx_start.reshape(-1).to(torch.int64))


def make_bins(m: int, device) -> torch.Tensor:
    """A fresh (4^m,) int64 tally table on ``device``."""
    return torch.zeros(4 ** m, dtype=torch.int64, device=device)

"""Device steps on one GPU: reads -> dense count rows.

Counterparts of ``kmtricks_tpu/parallel/pipeline.py`` (k-mer and hash
mode, k <= 128), as plain functions on tensors (no mesh, no collective):

* :func:`build_single_chip_step` (``build_single_chip_step``): encode
  (and the window hash), count+merge (sort and segment stage), then
  compaction, in one step;
* the streaming engine's steps: :func:`build_chunk_pairs_step` (one
  chunk -> one sorted pair run), the fold (``build_table_merge``, here
  ``ops/table.py::merge_pair_streams``), phase A
  :func:`table_sort_collapse`, phase B :func:`table_compact`, and the pa
  finalize :func:`merge_finalize_bits` (``build_merge_finalize_bits``).
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.ops.compact import compact_count_rows
from kmtricks_tpu_torch.ops.count_merge import (
    count_merge_keys, hash_key_bits, pack_words, sort_packed, stream_layout,
    unpack_sorted)
from kmtricks_tpu_torch.ops.encode import encode_batch, encode_batch_wide
from kmtricks_tpu_torch.ops.table import chunk_count_pairs, merge_pair_streams
from kmtricks_tpu_torch.ops.xxh64 import window_hash


def _on_words(keys, f):
    """``f`` applied to one key tensor, or to each word of wide keys."""
    if isinstance(keys, torch.Tensor):
        return f(keys)
    return tuple(f(w) for w in keys)


def encode(batch, lengths, repart_table, *, k: int, m: int,
           mmer_canonical: bool = True, static_parts: int | None = None):
    """The encode of the JAX package's ``_encode_flat``: ``encode_batch``
    for k <= 32 (keys one (B, W) int64 tensor), ``encode_batch_wide``
    beyond (keys a tuple of (B, W) int64 words, least significant first);
    ``static_parts`` = nb_partitions computes --static-repart partitions
    instead of gathering them from ``repart_table``."""
    enc = encode_batch if k <= 32 else encode_batch_wide
    return enc(batch, lengths, repart_table, k, m,
               mmer_canonical=mmer_canonical, static_parts=static_parts)


def build_single_chip_step(*, k: int, m: int, nsamp: int, nb_parts: int,
                           hard_min: int = 1, rmin: int = 1,
                           save_if: int = 0, count_max: int = 0xFFFFFFFF,
                           hard_min_vec=None, mmer_canonical: bool = True,
                           max_rows: int | None = None, mode: str = "kmer",
                           window_bits: int | None = None,
                           static_parts: int | None = None):
    """Return ``step(batch, lengths, samp, repart_table, amin_vec)`` over
    tensors on one device (see :func:`~kmtricks_tpu_torch.convert.
    from_jax_inputs`), giving compact_count_rows' (rows, pre, nrows, maxc,
    npres). ``mode="hash"`` counts window hashes of ``window_bits``-bit
    windows instead of k-mers (the rows' key column holds the hash);
    ``static_parts`` as :func:`encode`."""
    hashed = mode == "hash"
    key_bits = hash_key_bits(window_bits, nb_parts) if hashed else 2 * k

    def step(batch, lengths, samp, repart_table, amin_vec):
        keys, parts, valid = encode(batch, lengths, repart_table, k=k, m=m,
                                    mmer_canonical=mmer_canonical,
                                    static_parts=static_parts)
        if hashed:
            keys = window_hash(keys, parts, window_bits)
        sampw = samp[:, None].expand(parts.shape).reshape(-1)
        (part_s, key_s, samp_s, _final, cnt, present, row_head, _row_keep,
         _row_of) = count_merge_keys(
            parts.reshape(-1), _on_words(keys, lambda w: w.reshape(-1)),
            sampw, valid.reshape(-1),
            amin_vec, nsamp=nsamp, hard_min=hard_min, rmin=rmin,
            save_if=save_if, count_max=count_max, key_bits=key_bits,
            part_bits=(nb_parts - 1).bit_length(),
            hard_min_vec=hard_min_vec, part_follows_keys=hashed,
            window_bits=window_bits)
        return compact_count_rows(part_s, key_s, samp_s, cnt, present,
                                  row_head, nsamp=nsamp, max_rows=max_rows)

    return step


def build_chunk_pairs_step(*, k: int, m: int, nsamp: int, nb_parts: int,
                           mmer_canonical: bool = True, mode: str = "kmer",
                           window_bits: int | None = None,
                           static_parts: int | None = None):
    """Return ``step(batch, lengths, samp, repart_table)`` -> one sorted
    pair run (words tuple, cnt int64) of the chunk's valid windows:
    encode (and hash), pack, sort, then :func:`~kmtricks_tpu_torch.ops.
    table.chunk_count_pairs`. Inputs as for :func:`build_single_chip_step`."""
    layout = stream_layout(k, nb_parts, nsamp, mode, window_bits)

    def step(batch, lengths, samp, repart_table):
        keys, parts, valid = encode(batch, lengths, repart_table, k=k, m=m,
                                    mmer_canonical=mmer_canonical,
                                    static_parts=static_parts)
        sampw = samp[:, None].expand(parts.shape)
        keys, parts = _on_words(keys, lambda w: w[valid]), parts[valid]
        if mode == "hash":
            keys = window_hash(keys, parts, window_bits)
        words = pack_words(layout, parts, keys, sampw[valid], None, nsamp)
        return chunk_count_pairs(sort_packed(layout, words))

    return step


def _table_presence(layout, ws, cnt, nsamp, hard_min, window_bits):
    """Presence and row-head masks over a sorted collapsed table: an entry
    is present at ``hard_min``, and a row head is the first present entry
    of its key. Returns (part_s, key_s, samp_s, present, row_head)."""
    n = cnt.shape[0]
    part_s, key_s, samp_s, _valid, _occ_d, kd = unpack_sorted(
        layout, ws, nsamp, n, window_bits)
    present = cnt >= hard_min
    key_head = torch.ones(n, dtype=torch.bool, device=cnt.device)
    key_head[1:] = kd
    pi = present.to(torch.int64)
    excl = torch.cumsum(pi, 0) - pi
    group_base = torch.cummax(torch.where(key_head, excl, 0), 0).values
    return part_s, key_s, samp_s, present, present & (excl == group_base)


def _sorted_part_hist(part_s, row_head, nb_parts: int):
    """Rows per partition ((nb_parts,) int64): the partition of every row
    head, counted. The JAX package searches the sorted partition column
    instead, to avoid a TPU scatter-add."""
    return torch.bincount(part_s[row_head].to(torch.int64),
                          minlength=nb_parts)


def table_sort_collapse(runs):
    """Phase A (counterpart of ``build_table_sort_collapse``): merge the
    table's sorted pair runs (kernel K4) and collapse equal (partition,
    key, sample) entries into one with their saturated total -> (words,
    cnt). The JAX package keeps the collapsed duplicates as count-0
    shadows at full width and sizes phase B from its row count; here the
    table is exactly sized, so presence and row counts move to phase B."""
    return runs[0] if len(runs) == 1 else merge_pair_streams(runs)


def table_compact(ws, cnt, *, layout: str, nsamp: int, hard_min: int,
                  nb_parts: int, window_bits: int | None = None):
    """Phase B (counterpart of ``build_table_compact`` with ``nb_parts``):
    presence at the device ``hard_min``, dense compaction (:func:`~
    kmtricks_tpu_torch.ops.compact.compact_count_rows`) and the rows of
    each partition -> (rows, pre, part_rows, maxc, npres). Per-sample
    hard-min refinement and count_max clamping happen on the host, or in
    :func:`merge_finalize_bits`. ``window_bits``: hash layouts' window."""
    part_s, key_s, samp_s, present, row_head = _table_presence(
        layout, ws, cnt, nsamp, hard_min, window_bits)
    rows, pre, _nrows, maxc, npres = compact_count_rows(
        part_s, key_s, samp_s, cnt, present, row_head, nsamp=nsamp)
    return (rows, pre, _sorted_part_hist(part_s, row_head, nb_parts), maxc,
            npres)


# elements of ``pre`` per merge_finalize_bits block: its int64 and mask
# temporaries (about 40 B an element) stay near 0.7 GB however large the
# table
FINALIZE_BLOCK = 1 << 24


def merge_finalize_bits(pre, amin, hard_min, bounds, *, rmin: int,
                        save_if: int, count_max: int,
                        block: int = FINALIZE_BLOCK):
    """The merge for presence/absence outputs on the device (counterpart
    of ``build_merge_finalize_bits``): merge.hpp:183-260 over the dense
    pre-merge counts of phase B.

    ``pre`` (rows, nsamp) int32 holding u32 raw counts (0 = absent);
    ``amin`` and ``hard_min`` (nsamp,) int64 soft-min and per-sample
    hard-min; ``bounds`` (nb_parts + 1,) int64 row offsets of the
    partitions (rows are sorted by partition). A count is present at
    ``max(hard_min, 1)``, saturates at ``count_max``, is solid at ``amin``;
    a row is kept when solid in ``rmin`` samples, and a present non-solid
    count is rescued when its row is solid in ``save_if`` > 0 samples.

    Returns (packed (rows, ceil(nsamp / 8)) uint8 pa bits of solid or
    rescued counts, LSB first per byte as ``io/formats.py::pack_pa_bits``;
    keep (rows,) bool; stats (6, nb_parts, nsamp) int64: NON_SOLID,
    RESCUED, UNIQUE_WO_RESCUE, UNIQUE_W_RESCUE, TOTAL_WO_RESCUE,
    TOTAL_W_RESCUE per partition and sample). The statistics are exact
    int64 segment sums; the JAX package's u32 byte planes, which keep
    TPU sums below 2^32, are not needed. The rows go in blocks of about
    ``block`` counts, each adding its share of every partition's sums,
    so the temporaries do not grow with the table."""
    rows, nsamp = pre.shape
    dev = pre.device
    packed = torch.empty((rows, (nsamp + 7) // 8), dtype=torch.uint8,
                         device=dev)
    keep = torch.empty(rows, dtype=torch.bool, device=dev)
    stats = torch.zeros((6, bounds.numel() - 1, nsamp), dtype=torch.int64,
                        device=dev)
    step = max(1, block // max(nsamp, 1))
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        packed[lo:hi], keep[lo:hi], part = _finalize_block(
            pre[lo:hi], amin, hard_min, bounds.clamp(lo, hi) - lo,
            rmin=rmin, save_if=save_if, count_max=count_max)
        stats += part
    return packed, keep, stats


def _finalize_block(pre, amin, hard_min, bounds, *, rmin: int, save_if: int,
                    count_max: int):
    """:func:`merge_finalize_bits` over one block of rows; ``bounds`` are
    the partitions' offsets clamped to the block, so a partition outside
    it sums to 0."""
    rows, nsamp = pre.shape
    c = pre.to(torch.int64) & 0xFFFFFFFF
    present = c >= hard_min.clamp(min=1)
    sat = c.clamp_(max=count_max)
    del c
    solid = present & (sat >= amin)
    solid_in = solid.sum(dim=1)
    keep = solid_in >= rmin
    if save_if > 0:
        rescued = present & ~solid & (solid_in >= save_if)[:, None]
    else:
        rescued = torch.zeros_like(solid)
    final = solid | rescued
    nb8 = (nsamp + 7) // 8
    bits = torch.zeros((rows, nb8 * 8), dtype=torch.uint8, device=pre.device)
    bits[:, :nsamp] = final
    weights = 1 << torch.arange(8, dtype=torch.uint8, device=pre.device)
    packed = (bits.view(rows, nb8, 8) * weights).sum(dim=2,
                                                     dtype=torch.uint8)
    del bits

    # flat offsets of each partition's bounds in each sample's column
    at = (torch.arange(nsamp, device=pre.device)[:, None] * rows
          + bounds[None, :])

    def seg(vals):
        """Per-partition column sums over the contiguous row blocks: one
        prefix sum of the sample-major values, read at the bounds. (A
        cumsum down the rows of a narrow matrix runs one thread per
        column on CUDA: seconds at a million rows.)"""
        c = torch.zeros(rows * nsamp + 1, dtype=torch.int64,
                        device=pre.device)
        torch.cumsum(vals.t().reshape(-1), 0, dtype=torch.int64, out=c[1:])
        c = c[at]
        return (c[:, 1:] - c[:, :-1]).t()

    stats = torch.stack([
        seg(present & ~solid), seg(rescued), seg(solid), seg(final),
        seg(sat * solid), seg(sat * final)])
    return packed, keep, stats

"""Device steps on one GPU: reads -> dense count rows.

Counterparts of ``kmtricks_tpu/parallel/pipeline.py`` (k-mer mode,
k <= 32), as plain functions on tensors (no mesh, no collective):

* :func:`build_single_chip_step` (``build_single_chip_step``): encode,
  count+merge (sort and segment stage), then compaction, in one step;
* the streaming engine's steps: :func:`build_chunk_pairs_step` (one
  chunk -> one sorted pair run), the fold (``build_table_merge``, here
  ``ops/table.py::merge_pair_streams``), phase A
  :func:`table_sort_collapse` and phase B :func:`table_compact`.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.ops.compact import compact_count_rows
from kmtricks_tpu_torch.ops.count_merge import (
    count_merge_keys, pack_words, sort_packed, stream_layout, unpack_sorted)
from kmtricks_tpu_torch.ops.encode import encode_batch
from kmtricks_tpu_torch.ops.table import chunk_count_pairs, merge_pair_streams


def build_single_chip_step(*, k: int, m: int, nsamp: int, nb_parts: int,
                           hard_min: int = 1, rmin: int = 1,
                           save_if: int = 0, count_max: int = 0xFFFFFFFF,
                           hard_min_vec=None, mmer_canonical: bool = True,
                           max_rows: int | None = None):
    """Return ``step(batch, lengths, samp, repart_table, amin_vec)`` over
    tensors on one device (see :func:`~kmtricks_tpu_torch.convert.
    from_jax_inputs`), giving compact_count_rows' (rows, pre, nrows, maxc,
    npres)."""
    part_bits = (nb_parts - 1).bit_length()

    def step(batch, lengths, samp, repart_table, amin_vec):
        keys, parts, valid = encode_batch(batch, lengths, repart_table, k, m,
                                          mmer_canonical=mmer_canonical)
        sampw = samp[:, None].expand(parts.shape).reshape(-1)
        (part_s, key_s, samp_s, _final, cnt, present, row_head, _row_keep,
         _row_of) = count_merge_keys(
            parts.reshape(-1), keys.reshape(-1), sampw, valid.reshape(-1),
            amin_vec, nsamp=nsamp, hard_min=hard_min, rmin=rmin,
            save_if=save_if, count_max=count_max, key_bits=2 * k,
            part_bits=part_bits, hard_min_vec=hard_min_vec)
        return compact_count_rows(part_s, key_s, samp_s, cnt, present,
                                  row_head, nsamp=nsamp, max_rows=max_rows)

    return step


def build_chunk_pairs_step(*, k: int, m: int, nsamp: int, nb_parts: int,
                           mmer_canonical: bool = True):
    """Return ``step(batch, lengths, samp, repart_table)`` -> one sorted
    pair run (words tuple, cnt int64) of the chunk's valid windows:
    encode, pack, sort, then :func:`~kmtricks_tpu_torch.ops.table.
    chunk_count_pairs`. Inputs as for :func:`build_single_chip_step`."""
    layout = stream_layout(k, nb_parts, nsamp)

    def step(batch, lengths, samp, repart_table):
        keys, parts, valid = encode_batch(batch, lengths, repart_table, k, m,
                                          mmer_canonical=mmer_canonical)
        sampw = samp[:, None].expand(parts.shape)
        words = pack_words(layout, parts[valid], keys[valid], sampw[valid],
                           None, nsamp)
        return chunk_count_pairs(sort_packed(layout, words))

    return step


def _table_presence(layout, ws, cnt, nsamp, hard_min):
    """Presence and row-head masks over a sorted collapsed table: an entry
    is present at ``hard_min``, and a row head is the first present entry
    of its key. Returns (part_s, key_s, samp_s, present, row_head)."""
    n = cnt.shape[0]
    part_s, key_s, samp_s, _valid, _occ_d, kd = unpack_sorted(
        layout, ws, nsamp, n)
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
                  nb_parts: int):
    """Phase B (counterpart of ``build_table_compact`` with ``nb_parts``):
    presence at the device ``hard_min``, dense compaction (:func:`~
    kmtricks_tpu_torch.ops.compact.compact_count_rows`) and the rows of
    each partition -> (rows, pre, part_rows, maxc, npres). Per-sample
    hard-min refinement and count_max clamping happen on the host."""
    part_s, key_s, samp_s, present, row_head = _table_presence(
        layout, ws, cnt, nsamp, hard_min)
    rows, pre, _nrows, maxc, npres = compact_count_rows(
        part_s, key_s, samp_s, cnt, present, row_head, nsamp=nsamp)
    return (rows, pre, _sorted_part_hist(part_s, row_head, nb_parts), maxc,
            npres)

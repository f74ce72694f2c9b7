"""Fused count+merge: raw k-mer occurrences -> counted, merged rows.

Counterpart of ``kmtricks_tpu/ops/count_merge.py`` (packed path, k-mer
mode, k <= 32): one sort of (partition, key, sample) occurrence tuples,
then the segment stage (:mod:`kmtricks_tpu_torch.ops.segscan`) turns the
sorted runs into per-sample counts, hard-min, solid/rescue verdicts and
matrix rows.

Sort words are int64 with the top bit clear, fields packed most
significant first (partition | key | sample); invalid entries take the
INT64_MAX sentinel, so they sort last under PyTorch's signed order, and
the validity of a sorted position is its rank against the valid count.
Layout names follow the JAX package: "k2.<pb>.<kb>" packs into one word
when part_bits + key_bits + samp_bits <= 63; "k3" (k <= 32, partitions
<= 16 bits, samples <= 15 bits) takes two words sorted by a stable
two-pass sort, least significant word first.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.ops.segscan import INT32_MAX, segment_stage
from kmtricks_tpu_torch.ops.u64 import shr

INT64_MAX = 2**63 - 1
_LO32 = 0xFFFFFFFF


def _samp_bits(nsamp: int) -> int:
    return max(1, (nsamp - 1).bit_length())


def packed_layout(nsamp: int, key_bits: int, part_bits: int) -> str:
    """The JAX package's packed layout for k-mer keys of ``key_bits``
    (2k, k <= 32) and ``part_bits`` partition bits; raises for layouts
    this package has not ported."""
    sb = _samp_bits(nsamp)
    if 1 + part_bits + key_bits + sb <= 64:
        return f"k2.{part_bits}.{key_bits}"
    if sb <= 15 and part_bits <= 16:
        return "k3"
    raise NotImplementedError(
        f"no ported sort layout for {nsamp} samples, {part_bits} partition "
        f"bits and {key_bits} key bits")


def stream_layout(k: int, nb_parts: int, nsamp: int) -> str:
    """The streaming engine's packed layout (counterpart of
    ``kmtricks_tpu/parallel/pipeline.py::stream_layout``, k-mer mode,
    k <= 32): k2 or k3 from :func:`packed_layout`, which raises for
    layouts that do not pack (the JAX package takes ``stage_mesh_chunked``
    for those)."""
    return packed_layout(nsamp, 2 * k, (nb_parts - 1).bit_length())


def _layout_words(layout: str) -> int:
    """The JAX package's u32 word count of the layout (2 for k2, 3 for
    k3), which its table budget is written in; the port's int64 layouts
    take one word fewer."""
    if layout.startswith("k2."):
        return 2
    if layout == "k3":
        return 3
    raise NotImplementedError(layout)


def _k2_params(layout: str):
    _, pb, kb = layout.split(".")
    return int(pb), int(kb)


def pack_words(layout: str, part, keys, samp, valid, nsamp: int):
    """Pack (N,) occurrences into the layout's int64 sort words (most
    significant first). ``keys`` are int64 canonical k-mers; invalid
    entries take the INT64_MAX sentinel (``valid=None``: all valid)."""
    sb = _samp_bits(nsamp)
    part = part.to(torch.int64)
    samp = samp.to(torch.int64)
    if layout.startswith("k2."):
        _pb, kb = _k2_params(layout)
        words = ((part << (kb + sb)) | (keys << sb) | samp,)
    elif layout == "k3":
        words = ((part << 32) | shr(keys, 32), ((keys & _LO32) << sb) | samp)
    else:
        raise NotImplementedError(layout)
    if valid is None:
        return words
    return tuple(torch.where(valid, w, INT64_MAX) for w in words)


def sort_packed(layout: str, words):
    """Ascending sort of the packed words (lexicographic over the tuple)."""
    if len(words) == 1:
        return (torch.sort(words[0]).values,)
    hi, lo = words
    lo_s, perm = torch.sort(lo, stable=True)
    hi_s, perm2 = torch.sort(hi[perm], stable=True)
    return hi_s, lo_s[perm2]


def unpack_sorted(layout: str, ws, nsamp: int, n_valid):
    """Sorted words -> (part_s int32, key_s int64, samp_s int32, valid_s,
    occ_d, kd). Fields are 0 at invalid positions; ``occ_d``/``kd`` are the
    (N-1,) changes of adjacent entries at (key, sample) and key
    granularity, computed from the decoded fields."""
    sb = _samp_bits(nsamp)
    n = ws[0].shape[0]
    valid_s = torch.arange(n, device=ws[0].device) < n_valid
    smask = (1 << sb) - 1
    if layout.startswith("k2."):
        _pb, kb = _k2_params(layout)
        (w,) = ws
        samp = w & smask
        key = (w >> sb) & ((1 << kb) - 1)
        part = w >> (kb + sb)
    elif layout == "k3":
        hi, lo = ws
        samp = lo & smask
        key = (hi << 32) | (lo >> sb)
        part = hi >> 32
    else:
        raise NotImplementedError(layout)
    part_s = torch.where(valid_s, part, 0).to(torch.int32)
    key_s = torch.where(valid_s, key, 0)
    samp_s = torch.where(valid_s, samp, 0).to(torch.int32)

    def change(x):
        return x[1:] != x[:-1]

    kd = change(valid_s) | change(part_s) | change(key_s)
    occ_d = kd | change(samp_s)
    return part_s, key_s, samp_s, valid_s, occ_d, kd


def _thresholds(vec, samp_s, default: int):
    """Per-position int32 threshold: ``vec`` (nsamp,) int32 gathered by
    sample id, or ``default`` (saturated at INT32_MAX) everywhere."""
    if vec is None:
        return torch.full(samp_s.shape, min(default, INT32_MAX),
                          dtype=torch.int32, device=samp_s.device)
    return vec[samp_s.long()]


def count_merge_keys(part, keys, samp, valid, amin_vec, *, nsamp: int,
                     hard_min: int, rmin: int, save_if: int,
                     count_max: int = 0xFFFFFFFF, key_bits: int,
                     part_bits: int, hard_min_vec=None):
    """Count and merge raw occurrences in one sort + segment stage.

    part (N,) int32, keys (N,) int64 canonical k-mers, samp (N,) int32,
    valid (N,) bool, amin_vec (nsamp,) int32 soft-min thresholds; optional
    per-sample int32 ``hard_min_vec`` (both as
    :func:`~kmtricks_tpu_torch.convert.from_jax_inputs` makes them, u32
    values saturated at INT32_MAX). Returns, all sorted by (partition, key,
    sample) with padding last: (part_s int32, key_s int64, samp_s int32,
    final int32, cnt int32, present, row_head, row_keep, row_of int32) —
    the JAX ``count_merge_keys`` outputs without the statistics, which the
    compacted path rebuilds on the host.
    """
    layout = packed_layout(nsamp, key_bits, part_bits)
    words = pack_words(layout, part, keys, samp, valid, nsamp)
    ws = sort_packed(layout, words)
    part_s, key_s, samp_s, valid_s, occ_d, kd = unpack_sorted(
        layout, ws, nsamp, valid.sum())
    ones = torch.ones(1, dtype=torch.bool, device=kd.device)
    key_diff = torch.cat([ones, kd])
    occ_diff = torch.cat([ones, occ_d])
    amin_of = _thresholds(amin_vec, samp_s, 0)
    hmin_of = _thresholds(hard_min_vec, samp_s, hard_min)
    cnt, present, _solid, final, row_head, row_keep, row_of = segment_stage(
        occ_diff, key_diff, valid_s, amin_of, hmin_of, rmin=rmin,
        save_if=save_if, count_max=count_max)
    return (part_s, key_s, samp_s, final, cnt, present, row_head, row_keep,
            row_of)

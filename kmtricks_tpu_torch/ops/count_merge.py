"""Fused count+merge: raw k-mer occurrences -> counted, merged rows.

Counterpart of ``kmtricks_tpu/ops/count_merge.py`` (packed path, k-mer
and hash mode, k <= 128): one sort of (partition, key, sample) occurrence
tuples, then the segment stage (:mod:`kmtricks_tpu_torch.ops.segscan`)
turns the sorted runs into per-sample counts, hard-min, solid/rescue
verdicts and matrix rows.

Sort words are int64 with the top bit clear, fields packed most
significant first (partition | key | sample); invalid entries take the
INT64_MAX sentinel in every word, so they sort last under PyTorch's signed
order, and the validity of a sorted position is its rank against the
valid count. Layout names and routing follow the JAX package's u32
arithmetic, so the port takes a packed layout, or refuses, exactly where
the JAX package does: "k2.<pb>.<kb>" packs into one word when
part_bits + key_bits + samp_bits <= 63; "k3" (k <= 32, partitions <= 16
bits, samples <= 15 bits) takes two words; "kw.<pb>.<kb>.<nw>" (any k,
``nw`` the JAX package's u32 key words) right-justifies the fields in
ceil((pb + kb + sb) / 63) words of 63 bits: at most 2 for k <= 32, 3 for
k <= 64, 4 for k <= 96 and 5 for k <= 128 under the JAX package's bound
(fewer than 2 + nw u32 words). Several words sort by stable passes, least
significant word first. Window hashes (hash mode) embed their partition
(hash = XXH64 % window + window * partition), so the partition rides no
field: "h1" and "h2" (the JAX package's one- and two-u32 hash layouts)
are both ONE int64 word (hash << samp_bits | sample) here, and the
partition is decoded as hash // window.

Keys are one int64 tensor (k <= 32, window hashes) or a tuple of int64
words, least significant first (wide k-mers, ``ops/encode.py::
encode_batch_wide``); "kw" layouts decode them as such a tuple.

Where the JAX package's ``packed_layout`` returns None (for one sample:
window hashes of 63 or more bits, or more than 2^31 partitions),
:func:`count_merge_keys` takes the JAX package's generic branch instead:
an exact lexicographic sort of the unpacked fields (:func:`sort_unpacked`)
before the same segment stage. :func:`stream_layout` returns None there,
as the JAX package's does, and the fused path takes the host-aggregated
``runtime/device_pipeline.py::stage_mesh_chunked`` instead of the engine.

Over a mesh, each receiver gets one ascending run of packed words from
every shard; :func:`count_merge_packed` merges them (kernel K3 for one
word, K4 for more) before the segment stage, and :func:`part_of_sorted`
gives the router each sorted entry's partition.
"""

from __future__ import annotations

import torch

from kmtricks_tpu_torch.ops.encode import device_key_words
from kmtricks_tpu_torch.ops.merge_runs import merge_sorted_runs
from kmtricks_tpu_torch.ops.segscan import INT32_MAX, segment_stage
from kmtricks_tpu_torch.ops.u64 import flip, lex_perm, shr

INT64_MAX = 2**63 - 1
_LO32 = 0xFFFFFFFF


def _samp_bits(nsamp: int) -> int:
    return max(1, (nsamp - 1).bit_length())


def hash_key_bits(window_bits: int, nb_parts: int) -> int:
    """Bits of a window hash, which is below window_bits * nb_parts."""
    return (window_bits * nb_parts - 1).bit_length()


def packed_layout(nsamp: int, key_bits: int, part_bits: int | None,
                  part_follows_keys: bool = False) -> str | None:
    """The JAX package's ``packed_layout`` for keys of ``key_bits`` (2k
    k-mer bits with ``part_bits`` partition bits; or window hashes,
    ``part_follows_keys``): its layout name, or None where no layout
    packs."""
    sb = _samp_bits(nsamp)
    if part_follows_keys:
        if 1 + key_bits + sb <= 64:
            return "h1" if 1 + key_bits + sb <= 32 else "h2"
        return None
    nw = device_key_words(key_bits // 2)
    if nw == 2:
        if 1 + part_bits + key_bits + sb <= 64:
            return f"k2.{part_bits}.{key_bits}"
        if sb <= 15 and part_bits <= 16:
            return "k3"
    if part_bits <= 31 and -(-(1 + part_bits + key_bits + sb) // 32) < 2 + nw:
        return f"kw.{part_bits}.{key_bits}.{nw}"
    return None


def stream_layout(k: int, nb_parts: int, nsamp: int, mode: str = "kmer",
                  window_bits: int | None = None) -> str | None:
    """The streaming engine's and the fused step's packed layout
    (counterpart of ``kmtricks_tpu/parallel/pipeline.py::stream_layout``),
    or None where no layout packs: the fused path then takes the
    host-aggregated ``stage_mesh_chunked`` instead of the engine."""
    if mode == "hash":
        return packed_layout(nsamp, hash_key_bits(window_bits, nb_parts),
                             None, part_follows_keys=True)
    return packed_layout(nsamp, 2 * k, (nb_parts - 1).bit_length())


def _kw_params(layout: str, nsamp: int):
    """(part_bits, key_bits, int64 key words, the JAX package's u32 sort
    words, int64 sort words) of a "kw.<pb>.<kb>.<nw>" layout."""
    _, pb, kb, nw = layout.split(".")
    pb, kb, nw = int(pb), int(kb), int(nw)
    total = pb + kb + _samp_bits(nsamp)
    return pb, kb, nw // 2, -(-(1 + total) // 32), -(-total // 63)


def _layout_words(layout: str, nsamp: int) -> int:
    """The JAX package's u32 word count of the layout (1 for h1, 2 for h2
    and k2, 3 for k3, ``_kw_params``' for kw), which its table budget is
    written in; the port's int64 layouts take one word (k3: two; kw:
    ceil(bits / 63))."""
    if layout == "h1":
        return 1
    if layout == "h2" or layout.startswith("k2."):
        return 2
    if layout == "k3":
        return 3
    if layout.startswith("kw."):
        return _kw_params(layout, nsamp)[3]
    raise NotImplementedError(layout)


def _k2_params(layout: str):
    _, pb, kb = layout.split(".")
    return int(pb), int(kb)


def key_words(keys) -> tuple:
    """Keys as a tuple of int64 words, least significant first."""
    return (keys,) if isinstance(keys, torch.Tensor) else tuple(keys)


def _kw_fields(layout: str, nsamp: int):
    """(offset, width) of the sample, each key word (least significant
    first) and the partition in a kw layout's packed integer."""
    sb = _samp_bits(nsamp)
    pb, kb, nkw, _nwords, n64 = _kw_params(layout, nsamp)
    keys = [(sb + 64 * i, min(64, kb - 64 * i)) for i in range(nkw)]
    return (0, sb), keys, (sb + kb, pb), n64


def _bits_at(fields, lo: int) -> torch.Tensor:
    """Bits [lo, lo + 63) of the integer made of non-overlapping
    ``fields`` (value, offset, width <= 64), as a 63-bit int64 word."""
    out = None
    for v, o, w in fields:
        if w <= 0 or o >= lo + 63 or o + w <= lo:
            continue
        part = v << (o - lo) if o >= lo else shr(v, lo - o)
        out = part if out is None else out | part
    return out & INT64_MAX


def _bits_from(digits, a: int, w: int) -> torch.Tensor:
    """Bits [a, a + w), w <= 64, of the integer whose 63-bit digits are
    ``digits`` (least significant first)."""
    out = torch.zeros_like(digits[0])
    for d, x in enumerate(digits):
        lo = 63 * d
        if lo >= a + w or lo + 63 <= a:
            continue
        out |= x << (lo - a) if lo >= a else shr(x, a - lo)
    return out & ((1 << w) - 1) if w < 64 else out


def pack_words(layout: str, part, keys, samp, valid, nsamp: int):
    """Pack (N,) occurrences into the layout's int64 sort words (most
    significant first). ``keys``: canonical k-mers (one int64 tensor, or
    wide k-mers' words least significant first) or window hashes
    (``part`` unused); invalid entries take the INT64_MAX sentinel
    (``valid=None``: all valid)."""
    sb = _samp_bits(nsamp)
    part = part.to(torch.int64)
    samp = samp.to(torch.int64)
    if layout in ("h1", "h2"):
        words = ((keys << sb) | samp,)
    elif layout.startswith("k2."):
        _pb, kb = _k2_params(layout)
        words = ((part << (kb + sb)) | (keys << sb) | samp,)
    elif layout == "k3":
        words = ((part << 32) | shr(keys, 32), ((keys & _LO32) << sb) | samp)
    elif layout.startswith("kw."):
        (so, sw), kf, (po, pw), n64 = _kw_fields(layout, nsamp)
        fields = ([(samp, so, sw), (part, po, pw)]
                  + [(v, o, w) for v, (o, w) in zip(key_words(keys), kf)])
        words = tuple(_bits_at(fields, 63 * d)
                      for d in reversed(range(n64)))
    else:
        raise NotImplementedError(layout)
    if valid is None:
        return words
    return tuple(torch.where(valid, w, INT64_MAX) for w in words)


def part_of_sorted(layout: str, ws, nsamp: int,
                   window_bits: int | None = None) -> torch.Tensor:
    """The partition of each packed entry (int64; counterpart of
    ``part_of_sorted``): the router's destinations. Hash layouts decode it
    as key // ``window_bits``."""
    sb = _samp_bits(nsamp)
    if layout in ("h1", "h2"):
        return (ws[0] >> sb) // window_bits
    if layout.startswith("k2."):
        return ws[0] >> (_k2_params(layout)[1] + sb)
    if layout == "k3":
        return ws[0] >> 32
    if layout.startswith("kw."):
        _samp, _keys, (po, pw), _n64 = _kw_fields(layout, nsamp)
        if not pw:
            return torch.zeros_like(ws[0])
        return _bits_from(ws[::-1], po, pw)
    raise NotImplementedError(layout)


def sort_packed(layout: str, words):
    """Ascending sort of the packed words (lexicographic over the tuple):
    one sort for one word, else stable sorts least significant word
    first, each carrying the permutation so far."""
    if len(words) == 1:
        return (torch.sort(words[0]).values,)
    perm = lex_perm(reversed(words))
    return tuple(w[perm] for w in words)


def unpack_sorted(layout: str, ws, nsamp: int, n_valid,
                  window_bits: int | None = None):
    """Sorted words -> (part_s int32, key_s, samp_s int32, valid_s,
    occ_d, kd). ``key_s`` is one int64 tensor, or for kw layouts a tuple
    of int64 words, least significant first. Fields are 0 at invalid
    positions; ``occ_d``/``kd`` are the (N-1,) changes of adjacent entries
    at (key, sample) and key granularity, computed from the decoded
    fields. Hash layouts decode the partition as key // ``window_bits``."""
    sb = _samp_bits(nsamp)
    n = ws[0].shape[0]
    valid_s = torch.arange(n, device=ws[0].device) < n_valid
    smask = (1 << sb) - 1
    if layout in ("h1", "h2"):
        (w,) = ws
        samp = w & smask
        key = w >> sb
        part = key // window_bits
    elif layout.startswith("k2."):
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
    elif layout.startswith("kw."):
        (so, sw), kf, (po, pw), _n64 = _kw_fields(layout, nsamp)
        digits = ws[::-1]
        samp = _bits_from(digits, so, sw)
        key = tuple(_bits_from(digits, o, w) for o, w in kf)
        part = _bits_from(digits, po, pw) if pw else torch.zeros_like(samp)
    else:
        raise NotImplementedError(layout)
    part_s = torch.where(valid_s, part, 0).to(torch.int32)
    samp_s = torch.where(valid_s, samp, 0).to(torch.int32)

    def change(x):
        return x[1:] != x[:-1]

    kd = change(valid_s) | change(part_s)
    if isinstance(key, tuple):
        key_s = tuple(torch.where(valid_s, x, 0) for x in key)
        for x in key_s:
            kd |= change(x)
    else:
        key_s = torch.where(valid_s, key, 0)
        kd |= change(key_s)
    occ_d = kd | change(samp_s)
    return part_s, key_s, samp_s, valid_s, occ_d, kd


def sort_unpacked(part, keys, samp, valid, part_follows_keys: bool):
    """The JAX package's generic branch of ``count_merge_keys``, for keys
    no layout packs: an exact lexicographic sort of (invalid, partition,
    key words most significant first and unsigned, sample), the partition
    left out of the order when it follows the keys (window hashes), by
    stable sorts from the least significant operand. Returns the outputs
    of :func:`unpack_sorted`, but with the fields as sorted (not zeroed at
    invalid positions), as the JAX branch returns them."""
    kw = key_words(keys)
    inv = (~valid).to(torch.int64)
    top = inv if part_follows_keys else (inv << 32) | part.to(torch.int64)
    perm = lex_perm([samp.to(torch.int64)] + [flip(w) for w in kw] + [top])
    part_s, samp_s, valid_s = part[perm].to(torch.int32), \
        samp[perm].to(torch.int32), valid[perm]
    key_s = tuple(w[perm] for w in kw)

    def change(x):
        return x[1:] != x[:-1]

    kd = change(valid_s)
    for x in key_s:
        kd |= change(x)
    if not part_follows_keys:
        kd |= change(part_s)
    occ_d = kd | change(samp_s)
    if isinstance(keys, torch.Tensor):
        key_s = key_s[0]
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
                     part_bits: int | None = None, hard_min_vec=None,
                     part_follows_keys: bool = False,
                     window_bits: int | None = None):
    """Count and merge raw occurrences in one sort + segment stage.

    part (N,) int32, keys (N,) int64 canonical k-mers, or their words
    least significant first for k > 32 (or window hashes of ``key_bits``
    bits with ``part_follows_keys`` and ``window_bits``; the partition is
    then decoded from the hash), samp (N,) int32, valid (N,) bool,
    amin_vec (nsamp,) int32 soft-min thresholds; optional per-sample int32
    ``hard_min_vec`` (both as :func:`~kmtricks_tpu_torch.convert.
    from_jax_inputs` makes them, u32 values saturated at INT32_MAX).
    Returns, all sorted by (partition, key, sample) with padding last:
    (part_s int32, key_s (int64, or a tuple of int64 words in a kw layout),
    samp_s int32, final int32, cnt int32, present, row_head, row_keep,
    row_of int32) —
    the JAX ``count_merge_keys`` outputs without the statistics, which the
    compacted path rebuilds on the host. Keys no layout packs take
    :func:`sort_unpacked`.
    """
    layout = packed_layout(nsamp, key_bits, part_bits, part_follows_keys)
    if layout is None:
        unpacked = sort_unpacked(part, keys, samp, valid, part_follows_keys)
    else:
        words = pack_words(layout, part, keys, samp, valid, nsamp)
        ws = sort_packed(layout, words)
        unpacked = unpack_sorted(layout, ws, nsamp, valid.sum(), window_bits)
    return _segment(unpacked, amin_vec, hard_min=hard_min, rmin=rmin,
                    save_if=save_if, count_max=count_max,
                    hard_min_vec=hard_min_vec)


def count_merge_packed(sorted_runs, amin_vec, *, layout: str, nsamp: int,
                       hard_min: int, rmin: int, save_if: int,
                       count_max: int = 0xFFFFFFFF, hard_min_vec=None,
                       window_bits: int | None = None):
    """:func:`count_merge_keys` over one receiver's routed runs of packed
    sort words (counterpart of ``count_merge_packed(sorted_runs=)``):
    ``sorted_runs`` is a list of ascending runs of valid occurrences, each
    a tuple of the layout's int64 words (exactly sized, maybe empty),
    which :func:`merge_routed` merges (K3 for one word, K4 without
    payload for more; one run needs no merge). Unlike the JAX package,
    which merges routed runs only where its ``_use_routed_merge`` says so
    and re-sorts elsewhere, the runs are merged on every device: equal
    packed words are equal values, so a merge and a sort give the same
    bits. Same outputs as :func:`count_merge_keys`."""
    ws = merge_routed(sorted_runs)
    unpacked = unpack_sorted(layout, ws, nsamp, ws[0].shape[0], window_bits)
    return _segment(unpacked, amin_vec, hard_min=hard_min, rmin=rmin,
                    save_if=save_if, count_max=count_max,
                    hard_min_vec=hard_min_vec)


def merge_routed(runs) -> tuple:
    """One receiver's routed runs (ascending tuples of int64 sort words,
    exactly sized, maybe empty) -> one ascending run: one run as it is,
    more through the run merge (K3 for one word, K4 without payload for
    more)."""
    if len(runs) == 1:
        return tuple(runs[0])
    return merge_sorted_runs([(tuple(r), None) for r in runs])[0]


def _segment(unpacked, amin_vec, *, hard_min: int, rmin: int, save_if: int,
             count_max: int, hard_min_vec):
    """The segment stage (K1/K2) over :func:`unpack_sorted`'s outputs ->
    the outputs of :func:`count_merge_keys`."""
    part_s, key_s, samp_s, valid_s, occ_d, kd = unpacked
    n = valid_s.shape[0]
    ones = torch.ones(1, dtype=torch.bool, device=kd.device)
    key_diff = torch.cat([ones, kd])[:n]
    occ_diff = torch.cat([ones, occ_d])[:n]
    amin_of = _thresholds(amin_vec, samp_s, 0)
    hmin_of = _thresholds(hard_min_vec, samp_s, hard_min)
    cnt, present, _solid, final, row_head, row_keep, row_of = segment_stage(
        occ_diff, key_diff, valid_s, amin_of, hmin_of, rmin=rmin,
        save_if=save_if, count_max=count_max)
    return (part_s, key_s, samp_s, final, cnt, present, row_head, row_keep,
            row_of)

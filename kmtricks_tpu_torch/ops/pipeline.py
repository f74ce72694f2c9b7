"""Per-sample device count: one sample's reads -> per-partition tables.

Counterpart of ``kmtricks_tpu/ops/pipeline.py`` (``pad_reads``,
``count_sample_device``; k <= 128, k-mer and hash mode), the counter of
the per-stage device backend (``--backend device``): the reads are padded
into one (B, L) batch on the host, encoded (and hashed) on the device,
counted by :func:`~kmtricks_tpu_torch.ops.count_merge.count_merge_keys`
with one sample (one launch each of kernels K1 and K2 on a CUDA device),
and the present entries come back to the host, where hard-min, the
``count_max`` saturation and the per-partition split give exactly the
``SampleCounts`` of ``host/ops.py::count_sequences``.
"""

from __future__ import annotations

import numpy as np
import torch

from kmtricks_tpu_torch.host.ops import SampleCounts
from kmtricks_tpu_torch.ops.count_merge import (
    count_merge_keys, hash_key_bits, key_words)
from kmtricks_tpu_torch.ops.encode import encode_batch, encode_batch_wide
from kmtricks_tpu_torch.ops.xxh64 import window_hash
from kmtricks_tpu_torch.runtime import trace

BUCKET = 128


def _round_up(n: int, m: int = BUCKET) -> int:
    return ((n + m - 1) // m) * m


def pad_reads(sequences: list[bytes], k: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack reads into a (B, L) uint8 batch + (B,) lengths (copy of the
    JAX package's ``pad_reads``).

    Reads shorter than k are dropped (they produce no windows); L is the
    max length rounded up to the bucket size, and so is B. Padding byte is
    'N' (invalid) so padded windows are masked out by validity alone.
    """
    seqs = [s for s in sequences if len(s) >= k]
    if not seqs:
        return np.zeros((0, k), dtype=np.uint8), np.zeros(0, dtype=np.int32)
    L = _round_up(max(len(s) for s in seqs))
    B = _round_up(len(seqs))
    batch = np.full((B, L), ord("N"), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        batch[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        lengths[i] = len(s)
    return batch, lengths


def count_sample_device(
    sequences: list[bytes],
    k: int,
    m: int,
    repart_table: np.ndarray,
    hard_min: int = 1,
    mode: str = "kmer",
    window_bits: int | None = None,
    count_max: int = 0xFFFFFFFF,
    hist=None,
    mmer_canonical: bool = True,
    *,
    device,
) -> SampleCounts:
    """Device-path equivalent of host.ops.count_sequences (k <= 128) on
    ``device`` (a CUDA device, or "cpu" for the kernels' plain versions).
    The histogram takes every count before hard-min, as the host's
    does."""
    if not 0 < k <= 128:
        raise ValueError(f"k = {k}: the device count takes k <= 128")
    if mode == "hash" and window_bits is None:
        raise ValueError("hash mode needs window_bits")
    nb_parts = int(repart_table.max()) + 1 if len(repart_table) else 1
    out = SampleCounts(kmer_size=k, nb_partitions=nb_parts)
    batch, lengths = pad_reads(sequences, k)
    if batch.shape[0] == 0:
        return out

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    enc = encode_batch if k <= 32 else encode_batch_wide
    keys, parts, valid = enc(up(batch, np.uint8), up(lengths, np.int32),
                             up(repart_table, np.int32), k, m,
                             mmer_canonical=mmer_canonical)
    del batch
    keys = (keys.reshape(-1) if k <= 32
            else tuple(w.reshape(-1) for w in keys))
    parts, valid = parts.reshape(-1), valid.reshape(-1)
    hashed = mode == "hash"
    if hashed:
        with trace.span("hash.window", int(parts.shape[0])):
            keys = window_hash(keys, parts, window_bits)
    (part_s, key_s, _samp, _final, cnt, present, _rh, _rk,
     _ro) = count_merge_keys(
        parts, keys, torch.zeros_like(parts), valid,
        torch.ones(1, dtype=torch.int32, device=parts.device), nsamp=1,
        hard_min=1, rmin=1, save_if=0, part_follows_keys=hashed,
        key_bits=(hash_key_bits(window_bits, nb_parts) if hashed else 2 * k),
        window_bits=window_bits if hashed else None,
        part_bits=None if hashed else (nb_parts - 1).bit_length())
    del keys, parts, valid

    # the present (key, sample) run heads, on the host: keys as the host's
    # little-endian u64 rows, partitions sorted ascending
    heads = torch.nonzero(present).squeeze(1)
    keys_np = torch.stack([w[heads] for w in key_words(key_s)], dim=1) \
        .cpu().numpy().view(np.uint64)
    counts = cnt[heads].cpu().numpy().astype(np.uint64)
    if hashed:
        kparts = (keys_np[:, 0] // np.uint64(window_bits)).astype(np.int64)
    else:
        kparts = part_s[heads].cpu().numpy().astype(np.int64)

    if hist is not None:
        hist.inc_counts(counts)
    out.n_kmers_total = len(counts)
    solid = counts >= hard_min
    keys_np, kparts = keys_np[solid], kparts[solid]
    counts = np.minimum(counts[solid], np.uint64(count_max)).astype(
        np.uint32)
    bounds = np.searchsorted(kparts, np.arange(nb_parts + 1))
    for p in range(nb_parts):
        sl = slice(int(bounds[p]), int(bounds[p + 1]))
        pk = keys_np[sl]
        out.partitions[p] = (pk if mode == "kmer" else pk.ravel(),
                             counts[sl])
    return out

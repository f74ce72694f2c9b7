"""Device steps: reads -> dense count rows, on one GPU or over a mesh.

Counterparts of ``kmtricks_tpu/parallel/pipeline.py`` (k-mer and hash
mode, k <= 128), as plain functions on tensors:

* the mesh (:func:`make_mesh`, :func:`partition_to_device`): a tuple of
  torch devices, one per shard, where a device may repeat (a mesh of four
  shards on one card, or on the CPU, as the JAX tests place an 8-device
  mesh on one CPU); each shard owns a contiguous block of partitions. A
  mesh that spans processes (``parallel/multihost.py::global_mesh``) holds
  this process's shards of ``world x local`` global ones: each process
  feeds its own rows, destinations count every global shard, and the runs
  for other processes' shards travel by :func:`_exchange`;
* :func:`build_sharded_pipeline` (``build_sharded_pipeline``, and
  ``build_single_chip_step`` with a mesh of one device): encode (and the
  window hash), count+merge (sort and segment stage), then compaction, in
  one step over a mesh. Each shard encodes its rows, packs and sorts its
  words and
  routes them to the owners of their partitions (:func:`_route_sorted`;
  :func:`_bucket_and_route` for keys no layout packs); each receiver
  merges what it gets (``ops/count_merge.py::count_merge_packed``, kernel
  K3 or K4) and runs the segment stage and the compaction;
* the streaming engine's steps: :func:`build_chunk_pairs_step` (one
  chunk -> one sorted pair run per shard), the fold (``build_table_merge``, here
  ``ops/table.py::merge_pair_streams``), phase A
  :func:`table_sort_collapse`, phase B :func:`table_compact`, and the
  merge :func:`merge_finalize` (``build_merge_finalize_bits``, and the
  host's ``merge_dense`` in the JAX package's dense tails), each run per
  shard by the engine and the one step.

Where the JAX package pads each destination to a fixed ``cap`` with
sentinels for one ``all_to_all``, and counts what overflows, the port
splits each shard's sorted words into exactly sized runs and copies each
to its owner's device: nothing is dropped and nothing re-runs.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch
import torch.distributed as dist

from kmtricks_tpu_torch.ops.compact import INT32_MAX, compact_count_rows
from kmtricks_tpu_torch.ops.count_merge import (
    count_merge_keys, count_merge_packed, hash_key_bits, merge_routed,
    pack_words, packed_layout, part_of_sorted, sort_packed, stream_layout,
    unpack_sorted)
from kmtricks_tpu_torch.ops.encode import encode_batch, encode_batch_wide
from kmtricks_tpu_torch.ops.table import chunk_count_pairs, merge_pair_streams
from kmtricks_tpu_torch.ops.xxh64 import window_hash
from kmtricks_tpu_torch.parallel.multihost import ProcessMesh
from kmtricks_tpu_torch.runtime import trace


def make_mesh(devices=None) -> tuple:
    """The mesh: a tuple of torch devices, one per shard; a device may
    repeat. ``None`` takes every visible CUDA device, as the JAX
    package's ``make_mesh()`` takes every device (one shard on a machine
    with one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: no devices")
    # "cuda" names the current card: give it its index, as tensors do
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in mesh)


def partition_to_device(nb_parts: int, ndev: int) -> np.ndarray:
    """The shard that owns each partition: contiguous blocks,
    ``p * ndev // nb_parts`` (the JAX package's mapping)."""
    return np.arange(nb_parts, dtype=np.int64) * ndev // nb_parts


def _each_shard(mesh, fn) -> list:
    """``[fn(d) for each shard d]``, on one host thread per shard when the
    mesh spans more than one device (each shard's exact sizing syncs its
    device with the host, which would otherwise serialise the devices),
    in shard order otherwise."""
    def run(d):
        dev = mesh[d]
        with torch.cuda.device(dev) if dev.type == "cuda" else nullcontext():
            return fn(d)

    if len(set(mesh)) > 1:
        with ThreadPoolExecutor(max_workers=len(mesh)) as ex:
            return list(ex.map(run, range(len(mesh))))
    return [run(d) for d in range(len(mesh))]


def _send(ts, dev):
    """Tensors (or None, in nested tuples) on ``dev``: nothing moves where
    they are already there (a device repeated in the mesh). Between two
    cards torch's device-to-device copy records an event on the source's
    current stream and makes the destination's current stream wait on
    it, so the receiver's kernels see the whole run; from pinned host
    memory the upload runs asynchronously."""
    def move(t):
        if isinstance(t, tuple):
            return tuple(move(x) for x in t)
        if t is None or t.device == dev:
            return t
        return t.to(dev, non_blocking=True)

    return move(ts)


def _dest_bounds(dest, ndev: int) -> list:
    """Start of each destination's block in a non-decreasing ``dest``, and
    the end: (ndev + 1,) host ints."""
    q = torch.arange(ndev + 1, dtype=dest.dtype, device=dest.device)
    return torch.searchsorted(dest, q).tolist()


def rank_world(mesh) -> tuple[int, int]:
    """(rank, world) of the process holding ``mesh``: (0, 1) for a mesh
    of one process."""
    if isinstance(mesh, ProcessMesh):
        return mesh.rank, mesh.world
    return 0, 1


def _place(run, mesh, g: int):
    """A run for global shard ``g``: on its device where this process
    holds ``g``, else left where it is for :func:`_exchange`."""
    rank, _world = rank_world(mesh)
    n = len(mesh)
    return _send(run, mesh[g - rank * n]) if g // n == rank else run


def _route_sorted(layout: str, ws, mesh, *, nsamp: int, nb_parts: int,
                  window_bits: int | None = None) -> list:
    """One shard's sorted packed words -> the run for each global shard
    (counterpart of ``_route_sorted``): on that shard's device where this
    process holds it, else on this shard's device for
    :func:`_exchange`. The partition leads the k-mer layouts, and in hash
    layouts it is key // window, so the destinations are non-decreasing
    along the sorted words and each run is a slice, exactly sized (maybe
    empty)."""
    ndev = len(mesh) * rank_world(mesh)[1]
    if ndev == 1:
        return [_send(tuple(ws), mesh[0])]
    dest = part_of_sorted(layout, ws, nsamp, window_bits) * ndev // nb_parts
    b = _dest_bounds(dest, ndev)
    return [_place(tuple(w[b[g]:b[g + 1]] for w in ws), mesh, g)
            for g in range(ndev)]


def _bucket_and_route(part, keys, samp, mesh, *, nb_parts: int) -> list:
    """One shard's valid occurrences (keys no layout packs) -> the
    (part, keys, samp) of each global shard's partitions, placed as by
    :func:`_route_sorted` (counterpart of ``_bucket_and_route``): a
    stable grouping sort by destination, then exactly sized slices; the
    receiver sorts them (``ops/count_merge.py::sort_unpacked``)."""
    ndev = len(mesh) * rank_world(mesh)[1]
    if ndev == 1:
        return [_send((part, keys, samp), mesh[0])]
    dest = part.to(torch.int64) * ndev // nb_parts
    order = torch.argsort(dest, stable=True)
    b = _dest_bounds(dest[order], ndev)
    part, samp = part[order], samp[order]
    keys = _on_words(keys, lambda w: w[order])
    return [_place((part[b[g]:b[g + 1]],
                    _on_words(keys, lambda w: w[b[g]:b[g + 1]]),
                    samp[b[g]:b[g + 1]]), mesh, g) for g in range(ndev)]


def _routed(mesh, sent) -> list:
    """What each local shard receives: ``sent[s][g]`` is the run local
    shard ``s`` routed to global shard ``g``; returns, for each local
    shard, the runs of every global shard in global order (those of other
    processes through :func:`_exchange`)."""
    rank, world = rank_world(mesh)
    n = len(mesh)
    got = [[None] * (n * world) for _ in range(n)]
    for d in range(n):
        for s in range(n):
            got[d][rank * n + s] = sent[s][rank * n + d]
    if world > 1:
        _exchange(mesh, sent, got)
    return got


def sync_mesh(mesh) -> None:
    """Wait for the work queued on each card of the mesh."""
    for dev in set(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _leaves(run) -> list:
    """The tensors of a run (nested tuples of equal-length 1-D tensors),
    in order."""
    if isinstance(run, tuple):
        return [t for x in run for t in _leaves(x)]
    return [run]


def _rebuild(template, leaves):
    """``template``'s nesting over the tensors of the iterator ``leaves``,
    each cast to the dtype of the template's tensor in its place."""
    if isinstance(template, tuple):
        return tuple(_rebuild(x, leaves) for x in template)
    return next(leaves).to(template.dtype)


def _exchange(mesh, sent, got) -> None:
    """The route between processes (``mesh`` a
    ``parallel/multihost.py::ProcessMesh``), issued on the calling thread
    after the shards' threads return, in the same order on every rank.
    ``sent[s][g]``: the run local shard ``s`` routed to global shard
    ``g`` (the same nesting and dtypes for every run; runs for this
    process's shards already on their devices). Fills ``got[d][g]``, the
    run global shard ``g`` of another process routed to local shard ``d``,
    on its device.

    The runs for each other rank are packed, source shard then
    destination shard, each run's tensors as int64 one after another,
    into one buffer. One ``all_to_all_single`` on the gloo group sends
    every rank the lengths of its runs, one on the default group the
    payload: under gloo, CUDA shards stage it through pinned host memory;
    under NCCL it stays on the rank's card. Every rank takes part, with
    empty runs where it has nothing to send."""
    t0 = time.perf_counter()
    n, (rank, world) = len(mesh), rank_world(mesh)
    template = sent[0][0]
    nleaf = len(_leaves(template))
    nccl = mesh.backend == "nccl"
    pin = not nccl and any(d.type == "cuda" for d in mesh)
    # (rank, local source shard, its destination shard) of each remote run
    remote = [(r, s, d) for r in range(world) if r != rank
              for s in range(n) for d in range(n)]
    # lengths[r, s * n + d]: the run local shard s routed to shard d of r
    lengths = torch.zeros((world, n * n), dtype=torch.int64)
    for r, s, d in remote:
        lengths[r, s * n + d] = _leaves(sent[s][r * n + d])[0].numel()
    got_len = torch.empty_like(lengths)
    dist.all_to_all_single(got_len, lengths, group=mesh.host_group)
    send_sizes = (lengths.sum(dim=1) * nleaf).tolist()
    recv_sizes = (got_len.sum(dim=1) * nleaf).tolist()
    home = mesh[0] if nccl else torch.device("cpu")
    send = torch.empty(sum(send_sizes), dtype=torch.int64, device=home,
                       pin_memory=pin)
    off = 0
    for r, s, d in remote:
        for t in _leaves(sent[s][r * n + d]):
            send[off:off + t.numel()].copy_(t, non_blocking=True)
            off += t.numel()
    # the copies into the buffer end before the collective reads it
    sync_mesh(mesh)
    recv = torch.empty(sum(recv_sizes), dtype=torch.int64, device=home,
                       pin_memory=pin)
    dist.all_to_all_single(recv, send, recv_sizes, send_sizes)
    if nccl:
        torch.cuda.synchronize(home)
    off = 0
    for r, s, d in remote:
        # the run shard s of rank r routed to local shard d
        m = int(got_len[r, s * n + d])
        run = _rebuild(template, iter(recv[off + i * m:off + (i + 1) * m]
                                      for i in range(nleaf)))
        got[d][r * n + s] = _send(run, mesh[d])
        off += m * nleaf
    ex = mesh.exchanged
    ex["bytes_sent"] += 8 * (sum(send_sizes) + lengths.numel())
    ex["bytes_received"] += 8 * (sum(recv_sizes) + got_len.numel())
    ex["seconds"] += time.perf_counter() - t0
    ex["calls"] += 1


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


def _shard_occurrences(batch, lengths, samp, repart_table, *, k: int,
                       m: int, mode: str, window_bits, mmer_canonical: bool,
                       static_parts):
    """One shard's rows -> its valid occurrences (part, keys, samp): the
    encode, the window hash in hash mode, and the validity mask."""
    keys, parts, valid = encode(batch, lengths, repart_table, k=k, m=m,
                                mmer_canonical=mmer_canonical,
                                static_parts=static_parts)
    sampw = samp[:, None].expand(parts.shape)
    keys, parts = _on_words(keys, lambda w: w[valid]), parts[valid]
    if mode == "hash":
        with trace.span("hash.window", int(parts.shape[0])):
            keys = window_hash(keys, parts, window_bits)
    return parts, keys, sampw[valid]


def _shard_rows(mesh, *ts) -> list:
    """Split row-major inputs over the shards (contiguous row blocks of
    near-equal size): one tuple of row blocks per shard."""
    return list(zip(*(torch.tensor_split(t, len(mesh)) for t in ts)))


def _cat_fields(got):
    """The (part, keys, samp) a receiver got from each shard, joined (keys
    one tensor or a tuple of words)."""
    part = torch.cat([g[0] for g in got])
    samp = torch.cat([g[2] for g in got])
    if isinstance(got[0][1], tuple):
        keys = tuple(torch.cat([g[1][j] for g in got])
                     for j in range(len(got[0][1])))
    else:
        keys = torch.cat([g[1] for g in got])
    return part, keys, samp


def _per_device(mesh, t) -> dict:
    """``t`` placed once on each distinct device of the mesh."""
    return {dev: _send(t, dev) for dev in set(mesh)}


def build_sharded_pipeline(mesh, *, k: int, m: int, nsamp: int,
                           nb_parts: int, hard_min: int = 1, rmin: int = 1,
                           save_if: int = 0, count_max: int = 0xFFFFFFFF,
                           hard_min_vec=None, mmer_canonical: bool = True,
                           max_rows: int | None = None, mode: str = "kmer",
                           window_bits: int | None = None,
                           static_parts: int | None = None):
    """Return ``step(batch, lengths, samp, repart_table, amin_vec)`` over
    the mesh (counterpart of ``build_sharded_pipeline`` with its row
    compaction): a list with one compact_count_rows' (rows, pre, nrows,
    maxc, npres) per shard, on its device, covering the partitions it
    owns (:func:`partition_to_device`); with one shard, the outputs of the
    JAX package's ``build_single_chip_step`` with its compaction.

    Inputs (as :func:`~kmtricks_tpu_torch.convert.from_jax_inputs` makes
    them, on any device): batch (B, L) uint8, lengths (B,) int32, sample
    ids (B,) int32, the repartition table (4^m,) int32 and the soft-mins
    (nsamp,) int32; ``hard_min_vec`` (nsamp,) int32 or None. The rows
    split over the shards in contiguous blocks and each block goes to its
    shard's device; ``mode="hash"`` counts window hashes of
    ``window_bits``-bit windows instead of k-mers (the rows' key column
    holds the hash), ``static_parts`` = nb_partitions computes
    --static-repart partitions. On a mesh that spans processes each
    process passes its own rows (``multihost.host_shard_bounds``) and gets
    its own shards' outputs. Each shard encodes its rows and keeps the
    valid windows; where a layout packs (k2, k3, kw; h1/h2) it packs and
    sorts them and routes the sorted words (:func:`_route_sorted`), and
    each receiver merges its runs (``count_merge_packed``: K3 or K4);
    otherwise it routes the unsorted occurrences
    (:func:`_bucket_and_route`) and each receiver sorts them
    (``count_merge_keys``' generic branch). Then the segment stage (K1/K2)
    and the compaction; ``max_rows`` bounds each shard's rows."""
    hashed = mode == "hash"
    key_bits = hash_key_bits(window_bits, nb_parts) if hashed else 2 * k
    part_bits = None if hashed else (nb_parts - 1).bit_length()
    layout = packed_layout(nsamp, key_bits, part_bits,
                           part_follows_keys=hashed)
    hmv = _per_device(mesh, hard_min_vec)
    enc = dict(k=k, m=m, mode=mode, window_bits=window_bits,
               mmer_canonical=mmer_canonical, static_parts=static_parts)

    def step(batch, lengths, samp, repart_table, amin_vec):
        rows = _shard_rows(mesh, batch, lengths, samp)
        tables = _per_device(mesh, (repart_table, amin_vec))

        def send(d):
            b, ln, sa = _send(rows[d], mesh[d])
            part, keys, sampw = _shard_occurrences(
                b, ln, sa, tables[mesh[d]][0], **enc)
            if layout is None:
                return _bucket_and_route(part, keys, sampw, mesh,
                                         nb_parts=nb_parts)
            words = pack_words(layout, part, keys, sampw, None, nsamp)
            return _route_sorted(layout, sort_packed(layout, words), mesh,
                                 nsamp=nsamp, nb_parts=nb_parts,
                                 window_bits=window_bits)

        got = _routed(mesh, _each_shard(mesh, send))

        def receive(d):
            dev = mesh[d]
            kw = dict(nsamp=nsamp, hard_min=hard_min, rmin=rmin,
                      save_if=save_if, count_max=count_max,
                      hard_min_vec=hmv[dev], window_bits=window_bits)
            if layout is None:
                part, keys, samp_r = _cat_fields(got[d])
                out = count_merge_keys(
                    part, keys, samp_r, torch.ones_like(part, dtype=torch.bool),
                    tables[dev][1], key_bits=key_bits, part_bits=part_bits,
                    part_follows_keys=hashed, **kw)
            else:
                out = count_merge_packed(got[d], tables[dev][1],
                                         layout=layout, **kw)
            part_s, key_s, samp_s, _final, cnt, present, row_head, _k, _r = \
                out
            return compact_count_rows(part_s, key_s, samp_s, cnt, present,
                                      row_head, nsamp=nsamp,
                                      max_rows=max_rows)

        return _each_shard(mesh, receive)

    return step


def build_chunk_pairs_step(mesh, *, k: int, m: int, nsamp: int,
                           nb_parts: int, mmer_canonical: bool = True,
                           mode: str = "kmer", window_bits: int | None = None,
                           static_parts: int | None = None):
    """Return ``step(batch, lengths, samp, repart_table)`` -> one sorted
    pair run (words tuple, cnt int64) per shard, on its device
    (counterpart of ``build_chunk_pairs_step``): each shard
    encodes its rows of the chunk, packs, sorts and routes its valid
    windows (:func:`_route_sorted`); each receiver merges its runs (K3 or
    K4, no payload) before ``ops/table.py::chunk_count_pairs``. Inputs as
    for :func:`build_sharded_pipeline`; the layout must pack
    (``stream_layout``). One device: a mesh of that device, and the only
    run of the list."""
    layout = stream_layout(k, nb_parts, nsamp, mode, window_bits)
    if layout is None:
        raise ValueError("the chunk pairs step needs a packed layout "
                         "(stage_mesh_chunked takes the others)")
    enc = dict(k=k, m=m, mode=mode, window_bits=window_bits,
               mmer_canonical=mmer_canonical, static_parts=static_parts)

    def step(batch, lengths, samp, repart_table):
        rows = _shard_rows(mesh, batch, lengths, samp)
        tables = _per_device(mesh, repart_table)

        def send(d):
            b, ln, sa = _send(rows[d], mesh[d])
            part, keys, sampw = _shard_occurrences(
                b, ln, sa, tables[mesh[d]], **enc)
            words = pack_words(layout, part, keys, sampw, None, nsamp)
            return _route_sorted(layout, sort_packed(layout, words), mesh,
                                 nsamp=nsamp, nb_parts=nb_parts,
                                 window_bits=window_bits)

        got = _routed(mesh, _each_shard(mesh, send))
        return _each_shard(mesh, lambda d: chunk_count_pairs(merge_routed(
            got[d])))

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
    hard-min refinement and count_max clamping happen in
    :func:`merge_finalize`. ``window_bits``: hash layouts' window."""
    part_s, key_s, samp_s, present, row_head = _table_presence(
        layout, ws, cnt, nsamp, hard_min, window_bits)
    rows, pre, _nrows, maxc, npres = compact_count_rows(
        part_s, key_s, samp_s, cnt, present, row_head, nsamp=nsamp)
    return (rows, pre, _sorted_part_hist(part_s, row_head, nb_parts), maxc,
            npres)


# elements of ``pre`` per merge_finalize block: its int64 and mask
# temporaries (about 40 B an element) stay near 0.7 GB however large the
# table
FINALIZE_BLOCK = 1 << 24


def merge_finalize(pre, amin, hard_min, bounds, *, rmin: int, save_if: int,
                   count_max: int, bits: bool, block: int = FINALIZE_BLOCK):
    """The merge on the device (counterpart of ``build_merge_finalize_bits``
    and of the host's ``merge_dense`` over the hard-min'd, saturated
    counts): merge.hpp:183-260 over dense pre-merge counts.

    ``pre`` (rows, nsamp) int32 holding u32 raw counts (0 = absent);
    ``amin`` and ``hard_min`` (nsamp,) int64 soft-min and per-sample
    hard-min; ``bounds`` (nb_parts + 1,) int64 row offsets of the
    partitions (rows are sorted by partition). A count is present at
    ``max(hard_min, 1)``, saturates at ``count_max``, is solid at ``amin``
    (compared with the saturated count, as the host merge does); a row is
    kept when solid in ``rmin`` samples, and a present non-solid count is
    rescued when its row is solid in ``save_if`` > 0 samples.

    Returns (out, keep (rows,) bool, stats (6, nb_parts, nsamp) int64:
    NON_SOLID, RESCUED, UNIQUE_WO_RESCUE, UNIQUE_W_RESCUE,
    TOTAL_WO_RESCUE, TOTAL_W_RESCUE per partition and sample). ``out`` is,
    with ``bits``, the (rows, ceil(nsamp / 8)) uint8 pa bits of solid or
    rescued counts, LSB first per byte as ``io/formats.py::pack_pa_bits``;
    else the final counts, the saturated count where solid or rescued and
    0 elsewhere, as (rows, nsamp) int32 holding u32 (the host reads them
    with ``.view(np.uint32)``). The statistics are exact int64 segment
    sums; the JAX package's u32 byte planes, which keep TPU sums below
    2^32, are not needed. The rows go in blocks of about ``block`` counts,
    each adding its share of every partition's sums, so the temporaries
    do not grow with the table."""
    rows, nsamp = pre.shape
    dev = pre.device
    out = (torch.empty((rows, (nsamp + 7) // 8), dtype=torch.uint8,
                       device=dev) if bits else
           torch.empty((rows, nsamp), dtype=torch.int32, device=dev))
    keep = torch.empty(rows, dtype=torch.bool, device=dev)
    stats = torch.zeros((6, bounds.numel() - 1, nsamp), dtype=torch.int64,
                        device=dev)
    step = max(1, block // max(nsamp, 1))
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        out[lo:hi], keep[lo:hi], part = _finalize_block(
            pre[lo:hi], amin, hard_min, bounds.clamp(lo, hi) - lo,
            rmin=rmin, save_if=save_if, count_max=count_max, bits=bits)
        stats += part
    return out, keep, stats


def _finalize_block(pre, amin, hard_min, bounds, *, rmin: int, save_if: int,
                    count_max: int, bits: bool):
    """:func:`merge_finalize` over one block of rows; ``bounds`` are the
    partitions' offsets clamped to the block, so a partition outside it
    sums to 0."""
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
    counts = sat * final
    out = _pack_bits(final) if bits else _as_u32_bits(counts)

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
        seg(sat * solid), seg(counts)])
    return out, keep, stats


def _pack_bits(mask):
    """(rows, nsamp) bool -> (rows, ceil(nsamp / 8)) uint8, LSB first per
    byte (``io/formats.py::pack_pa_bits``)."""
    rows, nsamp = mask.shape
    nb8 = (nsamp + 7) // 8
    bits = torch.zeros((rows, nb8 * 8), dtype=torch.uint8, device=mask.device)
    bits[:, :nsamp] = mask
    weights = 1 << torch.arange(8, dtype=torch.uint8, device=mask.device)
    return (bits.view(rows, nb8, 8) * weights).sum(dim=2, dtype=torch.uint8)


def _as_u32_bits(vals):
    """int64 values in [0, 2^32) -> int32 holding their u32 bit pattern."""
    return torch.where(vals > INT32_MAX, vals - 2**32, vals).to(torch.int32)

"""The fused count+merge over a mesh, the host-aggregated chunked path,
and the host input path of the engine.

Counterpart of ``kmtricks_tpu/runtime/device_pipeline.py``:

* :func:`stage_mesh_count_merge` (``stage_mesh_count_merge``, k-mer or
  hash keys): all samples' reads form one (B, L) batch, its rows split
  over the mesh's shards, and the sharded step
  (:func:`~kmtricks_tpu_torch.parallel.pipeline.build_sharded_pipeline`)
  counts and merges them into dense rows on each shard; each partition's
  rows are merged on their shard's device (rescue, keep and statistics:
  :func:`device_merge_write_partition`) and written by the host with the
  writers of :mod:`kmtricks_tpu_torch.runtime.pipeline`, so the run
  directory is byte-identical;
* :func:`stage_mesh_chunked` (``stage_mesh_chunked``): the path for sort
  layouts no packed word takes (``stream_layout`` None): each chunk runs
  the sharded step as a pure counter and the host aggregates the counts
  across chunks in exact uint64 before the hard-mins, histograms,
  soft-min and merges (``host/ops.py::merge_dense``,
  :func:`merge_write_partition`);
* the streaming engine's host side (numpy): :func:`stream_row_chunks`
  over :func:`_stream_sample_blocks`, :func:`prefetched`,
  :func:`chunk_source`, and the routing predicates. They are duplicated,
  not imported, because the JAX module imports ``jax.numpy`` at its top.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import queue
import threading

import numpy as np

import torch

from kmtricks_tpu_torch.convert import from_jax_inputs
from kmtricks_tpu_torch.core.hashers import HashWindow
from kmtricks_tpu_torch.core.histogram import KHist
from kmtricks_tpu_torch.host import ops as hops
from kmtricks_tpu_torch.io import formats as F
from kmtricks_tpu_torch.io import sequences as seqio
from kmtricks_tpu_torch.ops.encode import device_key_words
from kmtricks_tpu_torch.parallel import multihost as mh
from kmtricks_tpu_torch.parallel.pipeline import (
    build_sharded_pipeline, merge_finalize, partition_to_device, rank_world)
from kmtricks_tpu_torch.runtime import trace

log = logging.getLogger("kmtricks_tpu")


def _is_float_quantile(spec) -> bool:
    """--soft-min spec is a float quantile in (0, 1) (one of the three
    forms resolve_soft_min accepts: int | quantile | per-sample file)."""
    try:
        int(spec)
        return False
    except ValueError:
        pass
    try:
        return 0 < float(spec) < 1
    except ValueError:
        return False


def _needs_host_aggregation(opts) -> bool:
    """Histograms, and the float soft-min that needs them, take the
    streaming engine even when the collection fits one step."""
    return bool(opts.hist) or _is_float_quantile(opts.soft_min)


def _stream_sample_blocks(kmdir, opts, entries=None):
    """Yield (sample_idx, batch, lengths) blocks across the collection,
    or across ``entries`` ((sample index, fof entry) pairs), decoding up
    to ``opts.threads`` samples concurrently (gz inflate and the native
    parser release the GIL). With more than one thread the samples'
    blocks interleave in no fixed order."""
    if entries is None:
        entries = list(enumerate(kmdir.fof))
    threads = min(getattr(opts, "threads", 1) or 1, len(entries))
    if threads <= 1:
        for si, entry in entries:
            for got in seqio.iter_batches(entry.paths, opts.bam_filter()):
                yield (si,) + got
        return

    q: queue.Queue = queue.Queue(maxsize=threads + 2)
    done_item = object()
    err: list[BaseException] = []
    it = iter(entries)
    lock = threading.Lock()
    stop = threading.Event()

    def _put(item) -> bool:
        """put() that gives up when the consumer is gone (stop set)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            while not stop.is_set():
                with lock:
                    nxt = next(it, None)
                if nxt is None:
                    return
                si, entry = nxt
                for got in seqio.iter_batches(entry.paths,
                                              opts.bam_filter()):
                    if not _put((si,) + got):
                        return
        except BaseException as e:  # noqa: BLE001 - relayed to consumer
            err.append(e)
        finally:
            _put(done_item)

    ts = [threading.Thread(target=worker, daemon=True)
          for _ in range(threads)]
    for t in ts:
        t.start()
    try:
        done = 0
        while done < threads:
            if err:                 # fail fast, don't drain other samples
                raise err[0]
            item = q.get()
            if item is done_item:
                done += 1
                continue
            yield item
        if err:
            raise err[0]
    finally:
        # unblock any producer stuck on a full queue (consumer abandoned
        # mid-stream, e.g. a device error downstream)
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def stream_row_chunks(kmdir, opts, k: int, L: int, rows: int,
                      entries=None):
    """Stream the whole collection, or its samples ``entries`` ((sample
    index, fof entry) pairs), as (rows, L) uint8 chunks with (rows,)
    int32 lengths and sample ids; the last chunk holds only the rows that
    are left (the JAX package pads it to the fixed shape its programs
    were compiled for). Reads shorter than k are dropped; reads longer
    than L split into segments overlapping by k - 1, so every k-mer window
    appears exactly once. Host memory is bounded by one chunk."""
    step_over = L - k + 1
    state = {}

    def reset():
        state.update(buf=np.full((rows, L), ord("N"), np.uint8),
                     ln=np.zeros(rows, np.int32),
                     sa=np.zeros(rows, np.int32), fill=0)

    def place(block, lengths, si):
        """Bulk-copy (B, Lb <= L) rows into the chunk buffer."""
        i = 0
        while i < len(lengths):
            take = min(rows - state["fill"], len(lengths) - i)
            f0 = state["fill"]
            state["buf"][f0:f0 + take, :block.shape[1]] = block[i:i + take]
            state["ln"][f0:f0 + take] = lengths[i:i + take]
            state["sa"][f0:f0 + take] = si
            state["fill"] += take
            i += take
            if state["fill"] == rows:
                yield state["buf"], state["ln"], state["sa"]
                reset()

    reset()
    for si, batch, lengths in _stream_sample_blocks(kmdir, opts, entries):
        keep = lengths >= k
        if not keep.all():
            batch, lengths = batch[keep], lengths[keep]
        if not len(lengths):
            continue
        if batch.shape[1] <= L:
            yield from place(batch, lengths, si)
            continue
        # mixed block: bulk-place the short reads, split the long ones
        short = lengths <= L
        if short.any():
            yield from place(batch[short][:, :L], lengths[short], si)
        for row, n in zip(batch[~short], lengths[~short]):
            segs, slens = [], []
            for off in range(0, int(n) - k + 1, step_over):
                m = min(L, int(n) - off)
                if m < k:
                    break
                seg = np.full(L, ord("N"), np.uint8)
                seg[:m] = row[off:off + m]
                segs.append(seg)
                slens.append(m)
            yield from place(np.asarray(segs), np.asarray(slens, np.int32),
                             si)
    f = state["fill"]
    if f:
        yield state["buf"][:f], state["ln"][:f], state["sa"][:f]


def prefetched(gen, depth: int = 2, name: str | None = None):
    """Run a generator on a background thread with a bounded queue, so
    host decode overlaps device work. The worker starts at call time. An
    error on the worker is raised in the consumer: it fails the run
    rather than ending the stream early. A consumer that abandons the
    stream (closes the iterator, or drops it after an error) stops the
    worker, which closes ``gen`` and lets go of the items it held.

    ``name`` opens the spans ``<name>.decode`` on the worker (the time
    in ``gen`` alone, not the wait for room in the queue) and
    ``<name>.decode_wait`` on the consumer (the wait for an item)."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    end = object()
    err: list[BaseException] = []
    stop = threading.Event()
    decode = trace.span if name else contextlib.nullcontext

    def put(item) -> bool:
        """put() that gives up once the consumer is gone (stop set)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        it = iter(gen)
        try:
            while not stop.is_set():
                with decode(f"{name}.decode"):
                    item = next(it, end)
                if item is end or not put(item):
                    return
        except BaseException as e:   # re-raised in the consumer below
            err.append(e)
        finally:
            put(end)
            close = getattr(it, "close", None)
            if close is not None:
                close()

    threading.Thread(target=worker, name="prefetch", daemon=True).start()

    def iterate():
        try:
            while True:
                with decode(f"{name}.decode_wait"):
                    item = q.get()
                if item is end:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    return iterate()


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


MAX_READ_LEN = 4096     # longer reads split into overlapping segments


def _stream_rows(ests, k, chunk_windows) -> tuple[int, int]:
    """(L, rows) of the chunks decoded from banks of estimates ``ests``:
    rows of the longest read, at most MAX_READ_LEN, and about
    ``chunk_windows`` windows a chunk."""
    L = max(k, min(max(e.max_size for e in ests), MAX_READ_LEN))
    return L, max(1, chunk_windows // (L - k + 1))


def chunk_source(kmdir, opts, k, chunk_windows, batch, lengths, sarr,
                 use_stream):
    """Host chunks of about ``chunk_windows`` windows as numpy (rows, L)
    uint8 batches with lengths and sample ids, and the rows per chunk:
    decoded from the banks (rows of the longest read, at most
    MAX_READ_LEN), or slices of the loaded batch."""
    if use_stream:
        L, rows = _stream_rows([seqio.estimate(e.paths) for e in kmdir.fof],
                               k, chunk_windows)
        return stream_row_chunks(kmdir, opts, k, L, rows), rows
    rows = max(1, chunk_windows // (batch.shape[1] - k + 1))

    def slices():
        for lo in range(0, batch.shape[0], rows):
            yield batch[lo:lo + rows], lengths[lo:lo + rows], \
                sarr[lo:lo + rows]

    return slices(), rows


def lpt_owners(ests, world: int) -> list:
    """The rank that decodes each sample: greedy longest-processing-time
    over the bank estimates' sequence counts, largest first, ties to the
    lower index and rank (the JAX package's sample owners; every rank
    computes the same from the same estimates)."""
    order = sorted(range(len(ests)), key=lambda i: (-ests[i].sequences, i))
    loads = [0] * world
    owner = [0] * len(ests)
    for i in order:
        r = min(range(world), key=lambda q: (loads[q], q))
        owner[i] = r
        loads[r] += max(1, ests[i].sequences)
    return owner


def striped_chunks(kmdir, opts, k: int, chunk_windows: int, mesh):
    """The chunk source of a mesh that spans processes (counterpart of
    ``_mp_sharded_chunks``): this rank decodes only the samples
    :func:`lpt_owners` gives it, into local chunks of ``rows // world``
    rows (``rows`` as :func:`chunk_source`'s), decoded and pinned on a
    background thread. Before each global chunk one all-reduce of a
    has-data flag (``multihost.any_rank``, on the consumer's thread, so
    the collectives keep one order on every rank) ends the stream when no
    rank has data left; a rank whose samples are done feeds an empty
    chunk until then. Returns (CPU tensor chunks, rows of a global
    chunk)."""
    ests = [seqio.estimate(e.paths) for e in kmdir.fof]
    L, rows = _stream_rows(ests, k, chunk_windows)
    local_rows = max(1, rows // mesh.world)
    owner = lpt_owners(ests, mesh.world)
    entries = [(i, e) for i, e in enumerate(kmdir.fof)
               if owner[i] == mesh.rank]
    local = prefetched(host_tensors(stream_row_chunks(
        kmdir, opts, k, L, local_rows, entries=entries), mesh), 2,
        name="engine")
    empty = (torch.zeros((0, L), dtype=torch.uint8),
             torch.zeros(0, dtype=torch.int32),
             torch.zeros(0, dtype=torch.int32))

    def agreed():
        for item in itertools.chain(local, itertools.repeat(None)):
            if not mh.any_rank(mesh, item is not None):
                return
            yield empty if item is None else item

    return agreed(), local_rows * mesh.world


def host_tensors(gen, mesh):
    """numpy chunks -> CPU tensors, pinned when the mesh holds a GPU so
    that the uploads can run asynchronously (on the prefetch thread)."""
    pin = any(d.type == "cuda" for d in mesh)
    for arrs in gen:
        ts = tuple(torch.from_numpy(a) for a in arrs)
        yield tuple(t.pin_memory() for t in ts) if pin else ts


def _load_global_batch(kmdir, opts, ndev: int = 1):
    """All samples' reads as one 'N'-padded (B, L) uint8 batch with
    (B,) lengths and sample ids; L rounds up to 128 and B to
    lcm(ndev, 8), so the rows split evenly over ``ndev`` shards (the JAX
    package's shapes; reads shorter than k give no valid window)."""
    entries = list(kmdir.fof)
    nthreads = min(getattr(opts, "threads", 1) or 1, len(entries))
    if nthreads > 1:
        # gzip inflate and the native batch parser release the GIL
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            per_sample = list(ex.map(
                lambda e: seqio.load_batch(e.paths, opts.bam_filter()),
                entries))
    else:
        per_sample = [seqio.load_batch(e.paths, opts.bam_filter())
                      for e in entries]
    n_reads = sum(b.shape[0] for b, _ in per_sample)
    if not n_reads:
        raise ValueError("no sequences")
    L = max(b.shape[1] for b, _ in per_sample)
    L = math.ceil(L / 128) * 128
    align = math.lcm(ndev, 8)
    B = math.ceil(n_reads / align) * align
    batch = np.full((B, L), ord("N"), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    sarr = np.zeros(B, dtype=np.int32)
    off = 0
    for i, (b, ln) in enumerate(per_sample):
        batch[off:off + b.shape[0], :b.shape[1]] = b
        lengths[off:off + b.shape[0]] = ln
        sarr[off:off + b.shape[0]] = i
        off += b.shape[0]
    return batch, lengths, sarr


def rows_budget(nsamp: int, max_memory_mb: int, key_words: int = 2) -> int:
    """Device row budget of the compaction (the JAX package's rows_hbm):
    half of --max-memory over ~4 * (nsamp + key_words + 2) bytes per row
    (``key_words``: the JAX package's u32 key words, 2 for hashes and
    k <= 32), at least 4M rows, and rows * nsamp < 2^31."""
    row_bytes = 4 * (nsamp + key_words + 2)
    rows = max(1 << 22, _pow2ceil(
        int(max_memory_mb * 1e6 / 2 / row_bytes) + 1) // 2)
    return min(rows, _pow2ceil((1 << 31) // max(1, nsamp)) // 2)


def fetch_row_keys(rows, cf: str) -> np.ndarray:
    """The key columns of compacted rows ((nrows, slots + 1) int64 of the
    key words, least significant first, then the partition, on the
    device) on the host, in merge_dense's layout: (nrows, slots) u64
    k-mers (the host's little-endian u64 rows), or (nrows,) u64 window
    hashes in hash mode (counterpart of the JAX package's ``_keys_to_u64``
    and ``_decode_block_keys``; 2-D hash keys would give the bf and hash
    writers wrong bytes)."""
    keys = rows[:, :-1].contiguous().cpu().numpy().view(np.uint64)
    return keys[:, 0] if cf == "hash" else keys


def hash_window_bits(kmdir, cf: str) -> int | None:
    """The window size in bits from the run's hash.info (hash mode)."""
    if cf != "hash":
        return None
    return HashWindow.load(kmdir.hash_win).window_size_bits


def _mesh_common(kmdir, config, opts):
    """(count format, hash window bits, count_max, per-sample hard-mins)
    of the run (counterpart of ``_mesh_common``)."""
    # imported here: runtime.pipeline imports this module
    from kmtricks_tpu_torch.runtime.pipeline import parse_mode

    cf = parse_mode(opts.mode)[0]
    return (cf, hash_window_bits(kmdir, cf),
            (1 << (8 * config.count_bytes)) - 1,
            kmdir.fof.abundance_mins(opts.hard_min))


def _one_process(mesh, what: str) -> None:
    """Refuse a mesh that spans processes where ``what`` loads the
    collection in one process (as the JAX engine refuses non-streamed
    input there)."""
    if rank_world(mesh)[1] > 1:
        raise ValueError(f"{what} runs in one process; a mesh that spans "
                         f"processes takes the streaming engine with "
                         f"use_stream=True (each rank decodes its samples)")


def merge_write_partition(kmdir, config, opts, p: int, keys, pre,
                          amin_vec, device) -> None:
    """Merge partition ``p``'s dense rows (``keys`` and their pre-merge
    counts ``pre``, hard-min'd and saturated) on the host and write its
    outputs; ``device`` is the owner shard's (it transposes bft windows).
    The chunked path's tail, whose counts are host sums."""
    from kmtricks_tpu_torch.runtime.pipeline import write_merge_outputs

    with trace.span("tail.merge", len(pre)):
        res = hops.merge_dense(keys, pre, amin_vec, opts.recurrence_min,
                               opts.share_min)
    with trace.span("tail.write", len(pre)):
        write_merge_outputs(kmdir, config, opts, p, res, device)


def merge_inputs(dev, amin_vec, hard_mins, offsets) -> tuple:
    """The soft-min, the per-sample hard-mins and a shard's partition row
    offsets as int64 tensors on its device ``dev``: the ``amin``,
    ``hard_min`` and ``bounds`` of
    :func:`~kmtricks_tpu_torch.parallel.pipeline.merge_finalize`."""
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)
                 for a in (amin_vec, hard_mins, offsets))


def device_merge_write_partition(kmdir, config, opts, p: int, keys, pre,
                                 bounds, amin, hard_min,
                                 count_max: int) -> None:
    """Merge partition ``p``'s dense rows on their device and write its
    outputs: ``keys`` on the host; ``pre`` the partition's (rows, nsamp)
    int32 raw u32 counts on the owner shard's device, ``bounds`` its
    (2,) int64 row offsets there (0 and its rows), ``amin`` and
    ``hard_min`` (nsamp,) int64 on that device. The merge
    (:func:`~kmtricks_tpu_torch.parallel.pipeline.merge_finalize`: the
    per-sample hard-min, count_max saturation, solid, rescue, keep and the
    statistics) runs on the device, and only the final counts, keep flags
    and statistics cross to the host for the writers. Inside ``tail.merge``
    the span ``tail.merge.device`` holds the merge's launches and the span
    ``tail.merge.copy`` (``n``: bytes) the copy of the counts and keep
    flags, which first waits for the merge on the device. The counters
    ``tail.merge.kept`` (rows kept), ``tail.merge.rescued`` and
    ``tail.merge.final`` (cells rescued; cells solid or rescued) are read
    from what is on the host."""
    from kmtricks_tpu_torch.runtime.pipeline import write_merge_outputs

    n = int(pre.shape[0])
    with trace.span("tail.merge", n):
        with trace.span("tail.merge.device", n):
            counts, keep, stats = merge_finalize(
                pre, amin, hard_min, bounds, rmin=opts.recurrence_min,
                save_if=opts.share_min, count_max=count_max, bits=False)
        with trace.span("tail.merge.copy", counts.numel() *
                        counts.element_size() + keep.numel()):
            host_counts, host_keep = _to_host(counts), _to_host(keep)
        stats = hops.MergeStats(*stats[:, 0].cpu().numpy().astype(np.uint64))
        res = hops.MergeResult(keys=keys, counts=host_counts.view(np.uint32),
                               keep=host_keep, stats=stats)
        trace.count("tail.merge.kept", np.count_nonzero(host_keep))
        trace.count("tail.merge.rescued", stats.rescued.sum())
        trace.count("tail.merge.final", stats.uniq_w_rescue.sum())
    with trace.span("tail.write", n):
        write_merge_outputs(kmdir, config, opts, p, res, pre.device)


def _to_host(t) -> np.ndarray:
    """A tensor on the host as numpy: through page-locked memory from a
    card (a pageable copy of a partition's counts runs at a fraction of
    the link's rate), as it is on the CPU."""
    if t.device.type == "cpu":
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def stage_mesh_count_merge(kmdir, config, opts, repart, amin_vec: np.ndarray,
                           batch, lengths, sarr, mesh) -> None:
    """Count and merge the loaded collection over ``mesh`` in one step and
    write every partition's outputs, each shard's partitions in
    :func:`partition_to_device` order. ``opts.max_memory_mb`` sets each
    shard's row budget."""
    _one_process(mesh, "the one-step path")
    cf, window_bits, count_max, hard_mins = _mesh_common(kmdir, config, opts)
    nsamp = len(kmdir.fof)
    key_words = 2 if cf == "hash" else device_key_words(config.kmer_size)
    # per-sample `! amin` fof overrides ride the fused step directly
    hard_min_vec = (np.asarray(hard_mins, dtype=np.uint32)
                    if len(set(hard_mins)) != 1 else None)
    args = from_jax_inputs(batch, lengths, sarr, repart.table, amin_vec,
                           hard_min_vec, "cpu")
    step = build_sharded_pipeline(
        mesh, k=config.kmer_size, m=config.minim_size, nsamp=nsamp,
        nb_parts=config.nb_partitions, hard_min=hard_mins[0],
        rmin=opts.recurrence_min, save_if=opts.share_min,
        count_max=count_max, hard_min_vec=args[5],
        mmer_canonical=config.mmer_scheme != "forward",
        max_rows=rows_budget(nsamp, opts.max_memory_mb, key_words), mode=cf,
        window_bits=window_bits,
        static_parts=config.nb_partitions if opts.static_repart else None)
    log.info("mesh step: %d reads x %d (windows %d) over %d shard(s)",
             batch.shape[0], batch.shape[1],
             batch.shape[0] * (batch.shape[1] - config.kmer_size + 1),
             len(mesh))
    part_dev = partition_to_device(config.nb_partitions, len(mesh))
    for d, (rows, pre, nrows, _maxc, _npres) in enumerate(step(*args[:5])):
        with trace.span("tail.fetch") as fetch:
            keys = fetch_row_keys(rows, cf)
            # rows are sorted by (partition, key): partition blocks are
            # contiguous
            part = rows[:, -1].cpu().numpy()
            bounds = np.searchsorted(part,
                                     np.arange(config.nb_partitions + 1))
            fetch.n = keys.nbytes + part.nbytes
        if int(bounds[-1]) != nrows:
            raise RuntimeError(f"row partitions out of range: "
                               f"{int(bounds[-1])} of {nrows} rows")
        # the step applied the hard-mins and count_max: present at 1
        amin, ones, offsets = merge_inputs(mesh[d], amin_vec,
                                           np.ones(nsamp), bounds)
        for p in map(int, np.flatnonzero(part_dev == d)):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            device_merge_write_partition(
                kmdir, config, opts, p, keys[lo:hi], pre[lo:hi],
                offsets[p:p + 2] - lo, amin, ones, count_max)


def stage_mesh_chunked(kmdir, config, opts, repart, amin_vec, *, mesh,
                       chunk_windows: int, batch=None, lengths=None,
                       sarr=None, use_stream: bool = False) -> None:
    """Count the collection chunk by chunk over ``mesh`` and merge it on
    the host (counterpart of ``stage_mesh_chunked``), for the sort layouts
    no packed word takes.

    Each chunk (about ``chunk_windows`` windows, decoded from the banks
    with ``use_stream``, else sliced from the loaded batch) runs the
    sharded step as a pure counter: hard-min 1, recurrence 1, no rescue,
    no count cap. Its compacted rows and pre-merge counts give every
    present (partition, key, sample) count. The host then sums the counts
    of each (partition, key) across chunks in exact uint64 with one
    grouping sort, builds the histograms (written under --hist), applies
    the per-sample hard-mins (fof ``! amin``) and the count_max clamp,
    resolves a float soft-min from the histogram files (``amin_vec``
    None resolves the soft-min there), and merges and writes each
    partition. ``merge_dense`` takes the summed rows directly: the JAX
    package's ``merge_partition`` builds the same dense matrix from
    per-sample tables and then calls it. The sums being complete before
    any merge, the JAX package's ``streaming`` order (merge each partition
    as its tables are built) writes the same files and has no
    counterpart."""
    from kmtricks_tpu_torch.runtime.pipeline import resolve_soft_min

    _one_process(mesh, "the chunked path")
    cf, window_bits, count_max, hard_mins = _mesh_common(kmdir, config, opts)
    nsamp, k = len(kmdir.fof), config.kmer_size
    nb_parts = config.nb_partitions
    gen, rows_per_chunk = chunk_source(kmdir, opts, k, chunk_windows, batch,
                                       lengths, sarr, use_stream)
    step = build_sharded_pipeline(
        mesh, k=k, m=config.minim_size, nsamp=nsamp, nb_parts=nb_parts,
        hard_min=1, rmin=1, save_if=0, count_max=0xFFFFFFFF,
        mmer_canonical=config.mmer_scheme != "forward", mode=cf,
        window_bits=window_bits,
        static_parts=nb_parts if opts.static_repart else None)
    table = torch.from_numpy(repart.table.astype(np.int32))
    ones = torch.ones(nsamp, dtype=torch.int32)
    keys_l, part_l, pre_l = [], [], []
    n_chunks = 0
    for cb, cl, cs in prefetched(host_tensors(gen, mesh), 2):
        for rows, pre, _nrows, _maxc, _npres in step(cb, cl, cs, table,
                                                     ones):
            rk = fetch_row_keys(rows, cf)
            keys_l.append(rk[:, None] if rk.ndim == 1 else rk)
            part_l.append(rows[:, -1].cpu().numpy())
            pre_l.append(pre.cpu().numpy().view(np.uint32))
        n_chunks += 1
    if not n_chunks:
        raise ValueError("no sequences")
    log.info("mesh chunked: %d chunk(s) of %d rows over %d shard(s)",
             n_chunks, rows_per_chunk, len(mesh))
    keys, part, pre = _sum_rows(keys_l, part_l, pre_l)
    del keys_l, part_l, pre_l

    want_hists = opts.hist or (amin_vec is None
                               and _is_float_quantile(opts.soft_min))
    if want_hists:
        for s, entry in enumerate(kmdir.fof):
            hist = KHist(s, k)
            col = pre[:, s]
            hist.inc_counts(col[col > 0])
            F.write_hist_file(kmdir.get_hist_path(entry.id), hist)
    if amin_vec is None:
        amin_vec = resolve_soft_min(opts.soft_min, kmdir, nsamp)
    # per-sample hard-min on the summed counts, then the count_max clamp;
    # rows no sample keeps are no rows
    hmv = np.asarray(hard_mins, dtype=np.uint64)[None, :]
    pre = np.where(pre >= hmv, np.minimum(pre, np.uint64(count_max)),
                   np.uint64(0))
    keep = pre.any(axis=1)
    keys, part, pre = keys[keep], part[keep], pre[keep]
    if cf == "hash":
        keys = keys[:, 0]
    bounds = np.searchsorted(part, np.arange(nb_parts + 1))
    owner = partition_to_device(nb_parts, len(mesh))
    for p in range(nb_parts):
        sl = slice(int(bounds[p]), int(bounds[p + 1]))
        merge_write_partition(kmdir, config, opts, p, keys[sl], pre[sl],
                              amin_vec, mesh[owner[p]])


def _sum_rows(keys_l, part_l, pre_l):
    """Per-chunk compacted rows -> one row per (partition, key), in
    (partition, unsigned key) order, with its counts summed over the
    chunks: (keys (n, slots) u64, part (n,) int64, pre (n, nsamp) u64)."""
    keys = np.concatenate(keys_l)
    part = np.concatenate(part_l)
    pre = np.concatenate(pre_l)
    if len(pre_l) > 1:
        # lexsort's last key leads: partition, then the most significant
        # key word; unsigned u64 compares
        order = np.lexsort([keys[:, j] for j in range(keys.shape[1])]
                           + [part])
        keys, part, pre = keys[order], part[order], pre[order]
    n = len(part)
    head = np.ones(n, dtype=bool)
    if n:
        head[1:] = (part[1:] != part[:-1]) | (
            keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(head)
    if len(starts) == n:
        return keys, part, pre.astype(np.uint64)
    return (keys[starts], part[starts],
            np.add.reduceat(pre.astype(np.uint64), starts, axis=0))

"""One-device fused count+merge, and the host input path of the engine.

Counterpart of ``kmtricks_tpu/runtime/device_pipeline.py``:

* :func:`stage_count_merge` (``stage_mesh_count_merge`` on one device):
  all samples' reads form one (B, L) batch, the fused step
  (:mod:`kmtricks_tpu_torch.parallel.pipeline`) counts and merges them
  into dense rows on the device, and the host rebuilds rescue/keep/
  statistics per partition (``host/ops.py::merge_dense``) and writes them
  with the JAX package's own writers, so the run directory is
  byte-identical;
* the streaming engine's host side (numpy): :func:`stream_row_chunks`
  over :func:`_stream_sample_blocks`, :func:`prefetched`, and the routing
  predicates. They are duplicated, not imported, because the JAX module
  imports ``jax.numpy`` at its top.
"""

from __future__ import annotations

import logging
import math
import queue
import threading

import numpy as np

from kmtricks_tpu.host import ops as hops
from kmtricks_tpu.io import sequences as seqio
from kmtricks_tpu.runtime.pipeline import write_merge_outputs

from kmtricks_tpu_torch.convert import from_jax_inputs
from kmtricks_tpu_torch.parallel.pipeline import build_single_chip_step

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


def _stream_sample_blocks(kmdir, opts):
    """Yield (sample_idx, batch, lengths) blocks across the collection,
    decoding up to ``opts.threads`` samples concurrently (gz inflate and
    the native parser release the GIL). With more than one thread the
    samples' blocks interleave in no fixed order."""
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


def stream_row_chunks(kmdir, opts, k: int, L: int, rows: int):
    """Stream the whole collection as (rows, L) uint8 chunks with (rows,)
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
    for si, batch, lengths in _stream_sample_blocks(kmdir, opts):
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


def prefetched(gen, depth: int = 2):
    """Run a generator on a background thread with a bounded queue, so
    host decode overlaps device work. The worker starts at call time. An
    error on the worker is raised in the consumer: it fails the run
    rather than ending the stream early."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    end = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:   # re-raised in the consumer below
            err.append(e)
        finally:
            q.put(end)

    threading.Thread(target=worker, daemon=True).start()

    def iterate():
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item

    return iterate()


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _load_global_batch(kmdir, opts):
    """All samples' reads as one 'N'-padded (B, L) uint8 batch with
    (B,) lengths and sample ids; L rounds up to 128 and B to 8 (the JAX
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
    B = math.ceil(n_reads / 8) * 8
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


def rows_budget(nsamp: int, max_memory_mb: int) -> int:
    """Device row budget of the compaction (the JAX package's rows_hbm):
    half of --max-memory over ~4 * (nsamp + 4) bytes per row, at least
    4M rows, and rows * nsamp < 2^31."""
    row_bytes = 4 * (nsamp + 4)
    rows = max(1 << 22, _pow2ceil(
        int(max_memory_mb * 1e6 / 2 / row_bytes) + 1) // 2)
    return min(rows, _pow2ceil((1 << 31) // max(1, nsamp)) // 2)


def stage_count_merge(kmdir, config, opts, repart, amin_vec: np.ndarray,
                      batch, lengths, sarr, device) -> None:
    """Count and merge the loaded collection on ``device`` in one step and
    write every partition's matrix and merge_info."""
    nsamp = len(kmdir.fof)
    hard_mins = kmdir.fof.abundance_mins(opts.hard_min)
    # per-sample `! amin` fof overrides ride the fused step directly
    hard_min_vec = (np.asarray(hard_mins, dtype=np.uint32)
                    if len(set(hard_mins)) != 1 else None)
    args = from_jax_inputs(batch, lengths, sarr, repart.table, amin_vec,
                           hard_min_vec, device)
    step = build_single_chip_step(
        k=config.kmer_size, m=config.minim_size, nsamp=nsamp,
        nb_parts=config.nb_partitions, hard_min=hard_mins[0],
        rmin=opts.recurrence_min, save_if=opts.share_min,
        count_max=(1 << (8 * config.count_bytes)) - 1,
        hard_min_vec=args[5], mmer_canonical=config.mmer_scheme != "forward",
        max_rows=rows_budget(nsamp, opts.max_memory_mb))
    log.info("device step: %d reads x %d (windows %d) on %s",
             batch.shape[0], batch.shape[1],
             batch.shape[0] * (batch.shape[1] - config.kmer_size + 1), device)
    rows, pre, nrows, _maxc, _npres = step(*args[:5])
    rows = rows.cpu().numpy()
    pre = pre.cpu().numpy().view(np.uint32)
    keys = np.ascontiguousarray(rows[:, 0]).view(np.uint64).reshape(nrows, 1)
    # rows are sorted by (partition, key): partition blocks are contiguous
    bounds = np.searchsorted(rows[:, 1], np.arange(config.nb_partitions + 1))
    if int(bounds[-1]) != nrows:
        raise RuntimeError(f"row partitions out of range: {int(bounds[-1])} "
                           f"of {nrows} rows")
    for p in range(config.nb_partitions):
        sl = slice(int(bounds[p]), int(bounds[p + 1]))
        res = hops.merge_dense(keys[sl], pre[sl], amin_vec,
                               opts.recurrence_min, opts.share_min)
        write_merge_outputs(kmdir, config, opts, p, res)

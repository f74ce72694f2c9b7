"""One-device fused count+merge: the whole collection in one step.

Counterpart of ``kmtricks_tpu/runtime/device_pipeline.py::
stage_mesh_count_merge`` on one device: all samples' reads form one
(B, L) batch, the fused step (:mod:`kmtricks_tpu_torch.parallel.pipeline`)
counts and merges them into dense rows on the device, and the host
rebuilds rescue/keep/statistics per partition (``host/ops.py::
merge_dense``) and writes them with the JAX package's own writers, so the
run directory is byte-identical.
"""

from __future__ import annotations

import logging
import math

import numpy as np

from kmtricks_tpu.host import ops as hops
from kmtricks_tpu.io import sequences as seqio
from kmtricks_tpu.runtime.pipeline import write_merge_outputs

from kmtricks_tpu_torch.convert import from_jax_inputs
from kmtricks_tpu_torch.parallel.pipeline import build_single_chip_step

log = logging.getLogger("kmtricks_tpu")


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

"""Streaming matrix engine: banks -> device count table -> files.

Counterpart of the single-process body of ``kmtricks_tpu/runtime/
stream_engine.py::stage_mesh_stream`` (k-mer mode, k <= 32, one GPU).
Read chunks stream from the banks (or are sliced from a loaded batch) on
a background thread; each chunk reduces on the device to one sorted run
of unique (packed key, count) pairs; runs fold into one table whenever
their entries pass the table budget; then phase A merges the runs
(kernel K4) and collapses duplicates, phase B compacts the table to
dense rows, and the host tail applies the per-sample hard-min, writes
histograms, resolves a float soft-min and merges and writes each
partition with the JAX package's own code, so the run directory is
byte-identical.

Feature handling, as in the JAX engine:
- per-sample hard-min (fof ``! amin``): the device applies the minimum
  hard-min (1 when histograms are wanted); the host refines per sample
  on the fetched raw counts;
- histograms and the float soft-min: the table holds counts from hard-min
  1, so the host builds the histograms from the fetched rows and
  resolves the quantile thresholds before the merges;
- count_max saturation: clamped on the host after the hard-min.

Every size is exact, so the JAX engine's pair caps, overflow re-runs,
deferred folds, prologue quarters and compile-ahead machinery have no
counterpart here.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kmtricks_tpu.core.histogram import KHist
from kmtricks_tpu.host import ops as hops
from kmtricks_tpu.io import formats as F
from kmtricks_tpu.io import sequences as seqio
from kmtricks_tpu.runtime.pipeline import resolve_soft_min, write_merge_outputs

from kmtricks_tpu_torch.ops.count_merge import _layout_words, stream_layout
from kmtricks_tpu_torch.ops.table import merge_pair_streams
from kmtricks_tpu_torch.parallel.pipeline import (
    build_chunk_pairs_step, table_compact, table_sort_collapse)
from kmtricks_tpu_torch.runtime.device_pipeline import (
    _is_float_quantile, _pow2ceil, prefetched, stream_row_chunks)

log = logging.getLogger("kmtricks_tpu")

MAX_READ_LEN = 4096     # longer reads split into overlapping segments

# counts and phase walls of the most recent stage_mesh_stream run
last_run: dict = {}


def table_budget(max_memory_mb: int, layout: str) -> int:
    """The JAX engine's table budget in entries: a third of --max-memory
    over 4 bytes per u32 word and count, rounded down to a power of two,
    at least 32M entries."""
    nw = _layout_words(layout)
    return max(1 << 25, _pow2ceil(int(
        max_memory_mb * 1e6 / 3 / (4 * (nw + 1))) + 1) // 2)


def _chunk_source(kmdir, opts, k, chunk_windows, batch, lengths, sarr,
                  use_stream):
    """Host chunks of about ``chunk_windows`` windows as numpy (rows, L)
    uint8 batches with lengths and sample ids, and the rows per chunk:
    decoded from the banks (rows of the longest read, at most
    MAX_READ_LEN), or slices of the loaded batch."""
    if use_stream:
        longest = max(seqio.estimate(e.paths).max_size for e in kmdir.fof)
        L = max(k, min(longest, MAX_READ_LEN))
    else:
        L = batch.shape[1]
    rows = max(1, chunk_windows // (L - k + 1))
    if use_stream:
        return stream_row_chunks(kmdir, opts, k, L, rows), rows

    def slices():
        for lo in range(0, batch.shape[0], rows):
            yield batch[lo:lo + rows], lengths[lo:lo + rows], \
                sarr[lo:lo + rows]

    return slices(), rows


def _host_tensors(gen, device):
    """numpy chunks -> CPU tensors, pinned when the device is a GPU so
    that the upload can run asynchronously (on the prefetch thread)."""
    for arrs in gen:
        ts = tuple(torch.from_numpy(a) for a in arrs)
        if device.type == "cuda":
            ts = tuple(t.pin_memory() for t in ts)
        yield ts


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stage_mesh_stream(kmdir, config, opts, repart, amin_vec, *, device,
                      chunk_windows: int, table_cap: int | None = None,
                      batch=None, lengths=None, sarr=None,
                      use_stream: bool = False) -> None:
    """Count and merge the collection through the streaming engine on
    ``device`` and write every partition's outputs.

    ``chunk_windows``: windows per chunk (the one-step budget by
    default); ``table_cap``: the table budget in entries (default
    :func:`table_budget`), past which the runs fold into one table, and
    which one folded table may not exceed. ``use_stream`` decodes chunks
    from the banks; otherwise chunks are slices of the loaded ``batch``
    (with its ``lengths`` and sample ids ``sarr``). ``amin_vec`` None
    resolves the soft-min here, or after the histograms for a float
    quantile."""
    t_start = time.perf_counter()
    nsamp = len(kmdir.fof)
    k = config.kmer_size
    nb_parts = config.nb_partitions
    layout = stream_layout(k, nb_parts, nsamp)
    if amin_vec is None and not _is_float_quantile(opts.soft_min):
        amin_vec = resolve_soft_min(opts.soft_min, kmdir, nsamp)
    count_max = (1 << (8 * config.count_bytes)) - 1
    hard_mins = np.asarray(kmdir.fof.abundance_mins(opts.hard_min),
                           dtype=np.uint32)
    want_hists = opts.hist or amin_vec is None
    dev_hard_min = 1 if want_hists else int(hard_mins.min())
    if table_cap is None:
        table_cap = table_budget(opts.max_memory_mb, layout)

    gen, rows_per_chunk = _chunk_source(kmdir, opts, k, chunk_windows, batch,
                                        lengths, sarr, use_stream)
    chunks = prefetched(_host_tensors(gen, device), 2)
    step = build_chunk_pairs_step(
        k=k, m=config.minim_size, nsamp=nsamp, nb_parts=nb_parts,
        mmer_canonical=config.mmer_scheme != "forward")
    table = torch.from_numpy(repart.table.astype(np.int32)).to(device)

    runs = []
    n_chunks = n_folds = 0
    for cb, cl, cs in chunks:
        runs.append(step(cb.to(device, non_blocking=True),
                         cl.to(device, non_blocking=True),
                         cs.to(device, non_blocking=True), table))
        n_chunks += 1
        if sum(int(r[1].shape[0]) for r in runs) > table_cap:
            ws, cnt = merge_pair_streams(runs)
            n_folds += 1
            if cnt.shape[0] > table_cap:
                raise ValueError(
                    f"device table overflow ({cnt.shape[0]} entries > "
                    f"{table_cap} budget at --max-memory "
                    f"{opts.max_memory_mb} MB)")
            runs = [(ws, cnt)]
    if not runs:
        raise ValueError("no sequences")
    n_runs = len(runs)
    n_entries = sum(int(r[1].shape[0]) for r in runs)
    _sync(device)
    t_stream = time.perf_counter()
    log.info("streamed %d chunks (%d rows each) -> %d pair runs, %d "
             "entries, %d folds", n_chunks, rows_per_chunk, n_runs,
             n_entries, n_folds)

    ws, cnt = table_sort_collapse(runs)
    del runs
    _sync(device)
    t_a = time.perf_counter()
    rows, pre, part_rows, _maxc, _npres = table_compact(
        ws, cnt, layout=layout, nsamp=nsamp, hard_min=dev_hard_min,
        nb_parts=nb_parts)
    table_entries = int(cnt.shape[0])
    del ws, cnt
    _sync(device)
    t_b = time.perf_counter()
    _fetch_merge_write(kmdir, config, opts, rows, pre, part_rows, amin_vec,
                       hard_mins, count_max, want_hists)
    t_end = time.perf_counter()
    last_run.clear()
    last_run.update(
        chunks=n_chunks, rows_per_chunk=rows_per_chunk, runs=n_runs,
        folds=n_folds, run_entries=n_entries, table_entries=table_entries,
        rows=int(rows.shape[0]),
        walls_s={"chunk_loop": t_stream - t_start, "phase_a": t_a - t_stream,
                 "phase_b": t_b - t_a, "tail": t_end - t_b})


def _fetch_merge_write(kmdir, config, opts, rows, pre, part_rows, amin_vec,
                       hard_mins, count_max, want_hists) -> None:
    """The engine's host tail (counterpart of ``_fetch_merge_write`` and
    ``_fetch_merge_write_pipelined``): one device-to-host copy of the row
    keys, counts and partition sizes; per-sample hard-min on the raw
    counts, then count_max saturation; histograms (written under
    --hist); a float soft-min resolved from them; then each partition's
    merge and write, fanned over the -t thread pool."""
    nsamp = len(kmdir.fof)
    keys = rows[:, 0].contiguous().cpu().numpy().view(np.uint64)
    keys = keys.reshape(-1, 1)
    pre = pre.cpu().numpy().view(np.uint32)
    bounds = np.zeros(config.nb_partitions + 1, np.int64)
    np.cumsum(part_rows.cpu().numpy(), out=bounds[1:])
    if int(bounds[-1]) != keys.shape[0]:
        raise RuntimeError(f"partition sizes ({int(bounds[-1])} rows) "
                           f"disagree with the table ({keys.shape[0]})")
    if want_hists:
        hists = [KHist(s, config.kmer_size) for s in range(nsamp)]
        for s in range(nsamp):
            col = pre[:, s]
            hists[s].inc_counts(col[col > 0].astype(np.uint64))
        if opts.hist:
            for s, entry in enumerate(kmdir.fof):
                F.write_hist_file(kmdir.get_hist_path(entry.id), hists[s])
    if amin_vec is None:
        amin_vec = resolve_soft_min(opts.soft_min, kmdir, nsamp)
    # per-sample hard-min on RAW counts, then count-type saturation
    # (count_processor.hpp:61-72 order); a row may end up all zero
    pre_m = np.where(pre >= hard_mins[None, :], np.minimum(pre, count_max),
                     0)

    def merge_write(p):
        sl = slice(int(bounds[p]), int(bounds[p + 1]))
        res = hops.merge_dense(keys[sl], pre_m[sl], amin_vec,
                               opts.recurrence_min, opts.share_min)
        write_merge_outputs(kmdir, config, opts, p, res)

    nthreads = max(1, getattr(opts, "threads", 1) or 1)
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        for f in [ex.submit(merge_write, p)
                  for p in range(config.nb_partitions)]:
            f.result()

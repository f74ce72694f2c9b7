"""Streaming matrix engine: banks -> device count tables -> files.

Counterpart of ``kmtricks_tpu/runtime/stream_engine.py::
stage_mesh_stream`` (k-mer and hash mode, k <= 128; wide k-mers in "kw"
layouts of up to five sort words), over a mesh of devices
(``parallel/pipeline.py::make_mesh``; one shard on one GPU), or over a
mesh that spans processes (``parallel/multihost.py::global_mesh``: each
rank decodes its own samples and writes the partitions its shards own).
Read chunks stream from the banks (or are sliced from a loaded batch) on
a background thread; each chunk's rows split over the shards, and each
shard routes its packed windows to the owners of their partitions, so
that the chunk reduces to one sorted run of unique (packed key, count)
pairs per shard (each receiver merges its routed runs with K3/K4 first).
Each shard keeps its own table: its runs fold into one whenever their
entries pass the table budget (per shard); then phase A merges a shard's
runs (kernel K4) and collapses duplicates, phase B compacts its table to
dense rows, and the tail merges each partition on its owner shard's
device (``merge_finalize``: per-sample hard-min, count_max saturation,
solid, rescue, keep and statistics). The dense tail copies each
partition's final counts, keep flags and statistics to the host, which
writes them with the port's copy of the JAX package's writers, so the
run directory is byte-identical. ``pa:bin`` outputs (no plugin, no
histograms, the soft-min resolved) take the pa-bits tail instead: the
merge hands out packed bits, one call per shard.

Feature handling, as in the JAX engine:
- per-sample hard-min (fof ``! amin``): phase B applies the minimum
  hard-min (1 when histograms are wanted); the merge refines per sample;
- histograms and the float soft-min: the table holds counts from hard-min
  1, so the host fetches the raw counts, builds the histograms and
  resolves the quantile thresholds before the merges;
- count_max saturation: in the merge, after the hard-min.

Every size is exact, so the JAX engine's pair caps, overflow re-runs,
deferred folds, prologue quarters and compile-ahead machinery have no
counterpart here.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kmtricks_tpu_torch.core.histogram import KHist, compute_merge_thresholds
from kmtricks_tpu_torch.host import ops as hops
from kmtricks_tpu_torch.io import formats as F
from kmtricks_tpu_torch.ops.count_merge import _layout_words, stream_layout
from kmtricks_tpu_torch.ops.table import merge_pair_streams
from kmtricks_tpu_torch.parallel import multihost as mh
from kmtricks_tpu_torch.parallel.pipeline import (
    _each_shard, build_chunk_pairs_step, merge_finalize,
    partition_to_device, rank_world, sync_mesh, table_compact,
    table_sort_collapse)
from kmtricks_tpu_torch.runtime import trace
from kmtricks_tpu_torch.runtime.device_pipeline import (
    _is_float_quantile, _pow2ceil, chunk_source,
    device_merge_write_partition, fetch_row_keys, hash_window_bits,
    host_tensors, merge_inputs, prefetched, striped_chunks)

log = logging.getLogger("kmtricks_tpu")

# counts and phase walls (the seconds of its engine.* spans) of the most
# recent stage_mesh_stream run
last_run: dict = {}


def table_budget(max_memory_mb: int, layout: str, nsamp: int) -> int:
    """The JAX engine's table budget in entries: a third of --max-memory
    over 4 bytes per u32 word of its layout and count, rounded down to a
    power of two, at least 32M entries."""
    nw = _layout_words(layout, nsamp)
    return max(1 << 25, _pow2ceil(int(
        max_memory_mb * 1e6 / 3 / (4 * (nw + 1))) + 1) // 2)


def memory_for(entries: int, layout: str, nsamp: int) -> int:
    """The least --max-memory (MB) at which :func:`table_budget` holds
    ``entries``."""
    if entries <= 1 << 25:          # the budget's floor
        return 1
    nw = _layout_words(layout, nsamp)
    mb = -(-_pow2ceil(entries) * 12 * (nw + 1) // 10**6)
    while table_budget(mb, layout, nsamp) < entries:
        mb += 1
    return mb


def _exchanged(mesh) -> dict:
    """The totals of the mesh's run exchanges between processes so far
    (zeros for a mesh of one process)."""
    if isinstance(mesh, mh.ProcessMesh):
        return dict(mesh.exchanged)
    return {"bytes_sent": 0, "bytes_received": 0, "seconds": 0.0,
            "calls": 0}


def _owned(nb_parts: int, mesh) -> list:
    """(partition, local shard) of each partition this process's shards
    own, in partition order (:func:`~kmtricks_tpu_torch.parallel.pipeline.
    partition_to_device` over the global shards)."""
    rank, world = rank_world(mesh)
    n = len(mesh)
    owner = partition_to_device(nb_parts, n * world)
    return [(p, int(owner[p]) - rank * n) for p in range(nb_parts)
            if owner[p] // n == rank]


def _cat(arrays):
    return arrays[0] if len(arrays) == 1 else np.concatenate(arrays)


def stage_mesh_stream(kmdir, config, opts, repart, amin_vec, *, mesh,
                      chunk_windows: int, table_cap: int | None = None,
                      batch=None, lengths=None, sarr=None,
                      use_stream: bool = False) -> None:
    """Count and merge the collection through the streaming engine over
    ``mesh`` and write every partition's outputs.

    ``chunk_windows``: windows per chunk (the one-step budget by
    default); ``table_cap``: each shard's table budget in entries (default
    :func:`table_budget`), past which its runs fold into one table, and
    which one folded table may not exceed. ``use_stream`` decodes chunks
    from the banks; otherwise chunks are slices of the loaded ``batch``
    (with its ``lengths`` and sample ids ``sarr``). ``amin_vec`` None
    resolves the soft-min here, or after the histograms for a float
    quantile.

    On a mesh that spans processes (``parallel/multihost.py::
    global_mesh``; every rank calls this with the same arguments) the
    chunks stream from the banks, each rank decoding its own samples
    (``device_pipeline.py::striped_chunks``), the chunk step routes runs
    between processes, the histograms are summed over the ranks (rank 0
    writes the ``.hist`` files and the thresholds file, and every rank
    resolves the same thresholds), and each rank writes the partitions its
    shards own into the shared run directory; every rank returns once all
    have written."""
    # imported here: runtime.pipeline imports this module
    from kmtricks_tpu_torch.runtime.pipeline import (
        parse_mode, resolve_soft_min)

    with trace.span("engine.chunk_loop") as w_loop:
        rank, world = rank_world(mesh)
        if world > 1 and not use_stream:
            raise ValueError(
                "the engine on a mesh that spans processes streams from "
                "the banks (use_stream=True): each rank decodes its own "
                "samples")
        nsamp = len(kmdir.fof)
        k = config.kmer_size
        nb_parts = config.nb_partitions
        cf, mode, out = parse_mode(opts.mode)
        window_bits = hash_window_bits(kmdir, cf)
        layout = stream_layout(k, nb_parts, nsamp, cf, window_bits)
        if amin_vec is None and not _is_float_quantile(opts.soft_min):
            amin_vec = resolve_soft_min(opts.soft_min, kmdir, nsamp)
        count_max = (1 << (8 * config.count_bytes)) - 1
        hard_mins = np.asarray(kmdir.fof.abundance_mins(opts.hard_min),
                               dtype=np.uint32)
        want_hists = opts.hist or amin_vec is None
        dev_hard_min = 1 if want_hists else int(hard_mins.min())
        if table_cap is None:
            table_cap = table_budget(opts.max_memory_mb, layout, nsamp)

        if world > 1:
            chunks, rows_per_chunk = striped_chunks(kmdir, opts, k,
                                                    chunk_windows, mesh)
        else:
            gen, rows_per_chunk = chunk_source(kmdir, opts, k,
                                               chunk_windows, batch, lengths,
                                               sarr, use_stream)
            chunks = prefetched(host_tensors(gen, mesh), 2, name="engine")
        exchanged = _exchanged(mesh)
        step = build_chunk_pairs_step(
            mesh, k=k, m=config.minim_size, nsamp=nsamp, nb_parts=nb_parts,
            mmer_canonical=config.mmer_scheme != "forward", mode=cf,
            window_bits=window_bits,
            static_parts=nb_parts if opts.static_repart else None)
        table = torch.from_numpy(repart.table.astype(np.int32)).to(
            mesh[0])

        runs = [[] for _ in mesh]       # each shard's table: its pair runs

        def fold(d) -> int:
            """Fold shard ``d``'s runs into one table once they pass the
            budget; 1 if it folded."""
            if sum(int(r[1].shape[0]) for r in runs[d]) <= table_cap:
                return 0
            ws, cnt = merge_pair_streams(runs[d])
            if cnt.shape[0] > table_cap:
                raise ValueError(
                    f"device table overflow ({cnt.shape[0]} entries > "
                    f"{table_cap} budget at --max-memory "
                    f"{opts.max_memory_mb} MB): the budget holds them at "
                    f"--max-memory "
                    f"{memory_for(cnt.shape[0], layout, nsamp)} MB, and "
                    f"the rest of the collection may need more")
            runs[d] = [(ws, cnt)]
            return 1

        n_chunks = n_folds = local_rows = 0
        for cb, cl, cs in chunks:
            with trace.span("engine.chunk_step", int(cb.shape[0])):
                for d, run in enumerate(step(cb, cl, cs, table)):
                    runs[d].append(run)
            n_chunks += 1
            local_rows += int((cl > 0).sum())
            with trace.span("engine.fold"):
                n_folds += sum(_each_shard(mesh, fold))
        if not n_chunks:
            raise ValueError("no sequences")
        n_runs = sum(len(r) for r in runs)
        n_entries = sum(int(r[1].shape[0]) for rs in runs for r in rs)
        sync_mesh(mesh)
    with trace.span("engine.phase_a") as w_a:
        log.info("streamed %d chunks (%d rows each) over %d shard(s) -> "
                 "%d pair runs, %d entries, %d folds", n_chunks,
                 rows_per_chunk, len(mesh), n_runs, n_entries, n_folds)

        tables = _each_shard(mesh, lambda d: table_sort_collapse(runs[d]))
        del runs
        sync_mesh(mesh)
    with trace.span("engine.phase_b") as w_b:
        shard_entries = [int(cnt.shape[0]) for _ws, cnt in tables]

        def compact(d):
            ws, cnt = tables[d]
            rows, pre, part_rows, _maxc, _npres = table_compact(
                ws, cnt, layout=layout, nsamp=nsamp,
                hard_min=dev_hard_min, nb_parts=nb_parts,
                window_bits=window_bits)
            return rows, pre, part_rows

        shards = _each_shard(mesh, compact)
        del tables
        sync_mesh(mesh)
    with trace.span("engine.tail") as w_tail:
        pa_bits = (mode, out) == ("pa", "bin") and not opts.plugin \
            and not want_hists
        if pa_bits:
            _fetch_merge_write_pa_bits(kmdir, config, opts, cf, mesh,
                                       shards, amin_vec, hard_mins,
                                       count_max)
        else:
            _fetch_merge_write(kmdir, config, opts, cf, mesh, shards,
                               amin_vec, hard_mins, count_max, want_hists)
        if world > 1:
            mh.barrier(mesh)
    ex = _exchanged(mesh)
    last_run.clear()
    last_run.update(
        shards=len(mesh), rank=rank, world=world, chunks=n_chunks,
        rows_per_chunk=rows_per_chunk, local_rows=local_rows, runs=n_runs,
        folds=n_folds, run_entries=n_entries,
        table_entries=sum(shard_entries), shard_table_entries=shard_entries,
        rows=sum(int(r.shape[0]) for r, _p, _n in shards),
        tail="pa_bits" if pa_bits else "dense",
        exchange={key: ex[key] - exchanged[key] for key in ex},
        walls_s={"chunk_loop": w_loop.s, "phase_a": w_a.s,
                 "phase_b": w_b.s, "tail": w_tail.s})


def _fetch_shards(cf, shards, nb_parts):
    """Each shard's row keys and partition sizes on the host, joined in
    shard order, which is partition order (each shard owns a contiguous
    block of partitions, :func:`~kmtricks_tpu_torch.parallel.pipeline.
    partition_to_device`): (keys, partition row bounds (nb_parts + 1,),
    each shard's own row offsets of the partitions (nb_parts + 1,))."""
    keys = _cat([fetch_row_keys(rows, cf) for rows, _pre, _p in shards])
    local = []
    for _r, _pre, part_rows in shards:
        off = np.zeros(nb_parts + 1, np.int64)
        np.cumsum(part_rows.cpu().numpy(), out=off[1:])
        local.append(off)
    bounds = np.zeros(nb_parts + 1, np.int64)
    np.cumsum(sum(np.diff(off) for off in local), out=bounds[1:])
    if int(bounds[-1]) != keys.shape[0]:
        raise RuntimeError(f"partition sizes ({int(bounds[-1])} rows) "
                           f"disagree with the table ({keys.shape[0]})")
    return keys, bounds, local


def _histograms(pre, k: int, mesh) -> list:
    """Each sample's KHist of the counts of ``pre`` ((rows, nsamp) u32),
    summed over the ranks where the mesh spans processes: their rows hold
    disjoint partitions, so the sum is the clones' merge of
    histogram.hpp:77-135 (counterpart of ``_mp_merge_hists``, with one
    all-reduce in place of the run directory's partial files)."""
    hists = [KHist(s, k) for s in range(pre.shape[1])]
    for s, h in enumerate(hists):
        col = pre[:, s]
        h.inc_counts(col[col > 0].astype(np.uint64))
    if rank_world(mesh)[1] == 1:
        return hists
    fields = ("uniq", "total", "oob_lu", "oob_ln", "oob_uu", "oob_un")
    size = len(hists[0].hist_u)
    planes = mh.sum_over_ranks(mesh, np.stack([np.concatenate([
        h.hist_u, h.hist_n, np.array([getattr(h, f) for f in fields],
                                     dtype=np.uint64)]) for h in hists]))
    for h, row in zip(hists, planes):
        h.hist_u, h.hist_n = row[:size].copy(), row[size:2 * size].copy()
        for f, v in zip(fields, row[2 * size:]):
            setattr(h, f, int(v))
    return hists


def _fetch_merge_write(kmdir, config, opts, cf, mesh, shards, amin_vec,
                       hard_mins, count_max, want_hists) -> None:
    """The engine's dense tail (counterpart of ``_fetch_merge_write``,
    ``_fetch_merge_write_pipelined`` and ``_fetch_merge_write_multiproc``):
    one device-to-host copy of each local shard's row keys and partition
    sizes, in owner order; where histograms are wanted, the raw counts
    too, for the histograms (summed over the ranks; rank 0 writes them
    under --hist) and a float soft-min resolved from them (rank 0 writes
    the thresholds file); then each partition this process's shards own
    is merged on its shard's device and written
    (:func:`~kmtricks_tpu_torch.runtime.device_pipeline.
    device_merge_write_partition`), fanned over the -t thread pool."""
    rank = rank_world(mesh)[0]
    with trace.span("tail.fetch") as fetch:
        keys, bounds, local = _fetch_shards(cf, shards,
                                            config.nb_partitions)
        fetch.n = keys.nbytes + bounds.nbytes
        if want_hists:
            pre = _cat([p.cpu().numpy().view(np.uint32)
                        for _r, p, _n in shards])
            fetch.n += pre.nbytes
    if want_hists:
        with trace.span("tail.hists"):
            hists = _histograms(pre, config.kmer_size, mesh)
            del pre
            if opts.hist and rank == 0:
                for s, entry in enumerate(kmdir.fof):
                    F.write_hist_file(kmdir.get_hist_path(entry.id),
                                      hists[s])
            if amin_vec is None:
                # the float quantile (the engine resolves the other forms
                # first)
                amin_vec = np.asarray(compute_merge_thresholds(
                    hists, float(opts.soft_min),
                    kmdir.get_merge_th_path() if rank == 0 else None),
                    dtype=np.uint32)
    merge_args = [merge_inputs(p.device, amin_vec, hard_mins, local[d])
                  for d, (_r, p, _n) in enumerate(shards)]

    def merge_write(job):
        p, d = job
        lo, hi = int(local[d][p]), int(local[d][p + 1])
        amin, hard_min, offsets = merge_args[d]
        device_merge_write_partition(
            kmdir, config, opts, p, keys[int(bounds[p]):int(bounds[p + 1])],
            shards[d][1][lo:hi], offsets[p:p + 2] - lo, amin, hard_min,
            count_max)

    nthreads = max(1, getattr(opts, "threads", 1) or 1)
    with trace.span("tail.merge_write"), \
            ThreadPoolExecutor(max_workers=nthreads) as ex:
        for f in [ex.submit(merge_write, job)
                  for job in _owned(config.nb_partitions, mesh)]:
            f.result()


def _fetch_merge_write_pa_bits(kmdir, config, opts, cf, mesh, shards,
                               amin_vec, hard_mins, count_max) -> None:
    """The presence/absence tail (counterpart of
    ``_fetch_merge_write_pa_bits`` and ``_pa_write_multiproc``): the merge
    runs on each local shard's device (:func:`~kmtricks_tpu_torch.parallel.
    pipeline.merge_finalize` in its bits form), and only the row keys,
    packed pa bits, keep flags and per-partition statistics are copied to
    the host, shard by shard in owner order; the host writes the pa matrix
    and merge_info of each partition this process's shards own, its
    statistics from its owner shard."""
    nsamp = len(kmdir.fof)
    with trace.span("tail.fetch") as fetch:
        keys, bounds, local = _fetch_shards(cf, shards,
                                            config.nb_partitions)
        fetch.n = keys.nbytes + bounds.nbytes

    def finalize(d):
        pre = shards[d][1]
        packed, keep, stats = merge_finalize(
            pre, *merge_inputs(pre.device, amin_vec, hard_mins, local[d]),
            rmin=opts.recurrence_min, save_if=opts.share_min,
            count_max=count_max, bits=True)
        return packed.cpu().numpy(), keep.cpu().numpy(), stats.cpu().numpy()

    fin = _each_shard(mesh, finalize)
    packed, keep = _cat([f[0] for f in fin]), _cat([f[1] for f in fin])
    for p, d in _owned(config.nb_partitions, mesh):
        sl = slice(int(bounds[p]), int(bounds[p + 1]))
        with trace.span("tail.write", sl.stop - sl.start):
            _pa_write_partition(kmdir, config, opts, cf, p, keys[sl],
                                packed[sl], keep[sl],
                                fin[d][2][:, p].astype(np.uint64), nsamp)


def _pa_write_partition(kmdir, config, opts, cf, p, keys, packed, keep,
                        stats, nsamp) -> None:
    """Write one partition's pa matrix and merge_info from the device
    finalize's bit rows, keep flags and (6, nsamp) statistics."""
    out_path = kmdir.get_matrix_path(p, "pa", "bin", cf, opts.cpr)
    if cf == "kmer":
        F.write_pa_matrix_file(out_path, keys[keep], packed[keep],
                               config.kmer_size, nsamp, 0, p,
                               compressed=opts.cpr)
    else:
        F.write_pa_hash_matrix_file(out_path, keys[keep], packed[keep],
                                    nsamp, 0, p, compressed=opts.cpr)
    hops.MergeStats(*stats).serialize(kmdir.get_merge_info_path(p))
